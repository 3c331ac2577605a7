"""The norm kernel's variant rule, and its plain version against the
reference, on the CPU.

``norm_variant(n, d)`` picks the kernel variant the norm wrapper launches
(``csrc/distance.cu``): short-wide (a block of threads a row) where a warp
a row keeps too few reads in flight to fill the card, else a warp a row.  Both give the same bits on
the card (``tests/test_torch_cuda.py``); here the rule is held at its
boundaries and at every table the port runs it on: the router tables
(experts x d_model) of the MoE configs and the brute-force tables of the
ann-benchmarks shapes.  ``norms_plain``, the plain version both variants
are held to, is held against ``repro.core.knn.squared_norms`` (the
reference router's norms) and ``repro.kernels.distance.norms_pallas`` in
interpret mode within ``1e-5 |c|^2``: the three sum each row in different
orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.knn import squared_norms
from repro.kernels.distance import norms_pallas
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.distance import (K_BLOCK, NORM_SHORT_WIDE, NORM_WARP_ROW,
                                          NORM_WIDE_MAX_BLOCKS, NORM_WIDE_ROWS,
                                          norm_variant, norms_cuda, norms_plain)
from test_torch_models import (  # noqa: F401  (autouse fixtures)
    one_torch_thread,
    shared_state_untouched,
)

RTOL = 1e-5
#: (experts, d_model) of every MoE config
ROUTER_TABLES = {"deepseek-v3-671b": (256, 7168), "jamba-1.5-large-398b": (16, 8192),
                 "phi3.5-moe-42b-a6.6b": (16, 4096)}
#: the ann-benchmarks shapes of ``chip_smoke.py`` phase 7
BRUTE_TABLES = {"glove-100-angular": (1_183_514, 100),
                "sift-128-euclidean": (1_000_000, 128)}


def test_router_tables_are_the_moe_configs():
    got = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.moe is not None:
            got[arch] = (cfg.moe.num_experts, cfg.d_model)
    assert got == ROUTER_TABLES


@pytest.mark.parametrize("arch", sorted(ROUTER_TABLES))
def test_router_tables_take_the_short_wide_variant(arch):
    assert norm_variant(*ROUTER_TABLES[arch]) == NORM_SHORT_WIDE


@pytest.mark.parametrize("name", sorted(BRUTE_TABLES))
def test_brute_force_tables_keep_a_warp_a_row(name):
    assert norm_variant(*BRUTE_TABLES[name]) == NORM_WARP_ROW


@pytest.mark.parametrize("n,d,want", [
    (NORM_WIDE_ROWS - 1, 2 * K_BLOCK, NORM_SHORT_WIDE),  # the rows' boundary
    (NORM_WIDE_ROWS, 2 * K_BLOCK, NORM_WARP_ROW),
    (NORM_WIDE_ROWS - 1, K_BLOCK, NORM_WARP_ROW),  # one block a row: nothing to spread
    (16, K_BLOCK + 1, NORM_SHORT_WIDE),  # the width's boundary
    (1, 1, NORM_WARP_ROW),
    (0, 4096, NORM_SHORT_WIDE),
    (16, NORM_WIDE_MAX_BLOCKS * K_BLOCK, NORM_SHORT_WIDE),  # shared memory's
    (16, NORM_WIDE_MAX_BLOCKS * K_BLOCK + 1, NORM_WARP_ROW),
])
def test_norm_variant_at_its_boundaries(n, d, want):
    assert norm_variant(n, d) == want


@pytest.mark.parametrize("n,d", [(-1, 8), (4, 0)])
def test_norm_variant_refuses_an_empty_shape(n, d):
    with pytest.raises(ValueError, match="rows"):
        norm_variant(n, d)


@pytest.mark.parametrize("n,d,non_finite", [(16, 4096, False), (64, 256, False),
                                            (64, 256, True)])
def test_norms_plain_matches_the_reference(n, d, non_finite):
    """A router-like table (N(0, 1 / d), as ``init_params`` draws it) and
    a wider-valued one with -inf, +inf and NaN rows: finite norms within
    1e-5 |c|^2 of both reference functions, the non-finite ones equal."""
    rng = np.random.default_rng(n + d)
    c = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    if non_finite:
        c = c * np.float32(30.0)
        c[0, d - 1], c[n // 3, d // 2], c[n - 1, 0] = -np.inf, np.inf, np.nan
    got = norms_plain(torch.as_tensor(c))[0].numpy()
    want = {"squared_norms": np.asarray(squared_norms(jnp.asarray(c))),
            "norms_pallas": np.asarray(norms_pallas(jnp.asarray(c), bn=n, bk=K_BLOCK,
                                                    interpret=True))[0]}
    scale = (c.astype(np.float64) ** 2).sum(1)
    fin = np.isfinite(scale)
    for name, ref in want.items():
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=name)
        np.testing.assert_array_equal(got[np.isinf(ref)], ref[np.isinf(ref)], err_msg=name)
        assert np.all(np.abs(got[fin] - ref[fin]) <= RTOL * scale[fin]), name
    # on a CPU tensor the wrapper is its plain version
    t = torch.as_tensor(c)
    assert torch.equal(norms_cuda(t).view(torch.int32), norms_plain(t).view(torch.int32))
