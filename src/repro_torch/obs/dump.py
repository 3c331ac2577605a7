"""``python -m repro_torch.obs.dump [PATH]``: pretty-print a telemetry
snapshot.

Without arguments, prints the *current process's* ``obs.snapshot()``
(useful at the end of a script, or to see the stable empty-state
schema).  With a path, pretty-prints a snapshot previously saved with
``obs.write_snapshot`` (the CI artifact), so the uploaded JSON reads
back through the same tool.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import snapshot


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.dump",
        description="pretty-print a repro_torch.obs telemetry snapshot")
    ap.add_argument("path", nargs="?", default=None,
                    help="a saved snapshot JSON to print (default: the "
                         "current process's live snapshot)")
    args = ap.parse_args(argv)
    if args.path is None:
        snap = snapshot()
    else:
        with open(args.path) as f:
            snap = json.load(f)
    json.dump(snap, sys.stdout, indent=2, sort_keys=True)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
