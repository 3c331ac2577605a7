"""Model zoo of the port: config-driven language models in PyTorch.

The dense and MoE GQA families serve end to end (``prefill``,
``decode_step``, ``serving.Engine``); every config and its parameter and
cache shapes are here for all ten architectures.  What is still to port
raises ``NotImplementedError`` naming ``ROADMAP.md``.
"""
from .config import (  # noqa: F401
    EncoderConfig,
    LayerSpec,
    MLAConfig,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    derive_segments,
)
from .model import (  # noqa: F401
    cache_shapes,
    count_active_params,
    count_params,
    decode_step,
    init_cache,
    init_params,
    prefill,
)
