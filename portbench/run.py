"""Run one cell of BENCHMARK.json once:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the compared numbers and their limits are the last lines
of standard error. Exit codes: 0 a result was printed; 2 bad arguments;
3 no CUDA card, or fewer than the cell asks for; 4 JAX or the JAX
package was loaded. Nothing heavy is imported at module level: the
reference's worker processes start by importing this module.
"""
from __future__ import annotations

import time

T_PROC0 = time.perf_counter()

# the program's routing variables: unset, so that the product decides
PRODUCT_ENV = ("FOLDCOMP_TPU_WIRE", "FOLDCOMP_TPU_WCLASS",
               "FOLDCOMP_TPU_BATCH", "FOLDCOMP_TPU_LINK",
               "FOLDCOMP_TPU_PLANAR_WIRE", "FOLDCOMP_TORCH_DEVICE")


def set_environment(root):
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds; no library loads JAX."""
    import os
    cache = os.path.join(root, ".portbench_cache")
    os.environ["FOLDCOMP_TPU_TORCH_CACHE"] = os.path.join(cache, "port")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k in PRODUCT_ENV:
        os.environ.pop(k, None)


def fresh_tempdir() -> str:
    """A new directory under the temporary directory the run was given,
    made this run's temporary directory (tempfile and TMPDIR), so that
    nothing the program keeps there (such as the link probe's answer) is
    found by a later run; removed when the run ends."""
    import os
    import tempfile
    path = tempfile.mkdtemp(prefix="portbench_run_")
    os.environ["TMPDIR"] = path
    tempfile.tempdir = path
    return path


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from . import harness, manifest

    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="report the control's numbers (the reference in "
                        "bfloat16 in the program's place); not a "
                        "benchmark run")
    args = p.parse_args(argv)
    set_environment(str(manifest.ROOT))
    run_tmp = fresh_tempdir()
    try:
        rc, result = harness.run_cell(args.workload, args.seed,
                                      args.seconds, bool(args.trace),
                                      T_PROC0, control=bool(args.control))
    finally:
        import shutil
        shutil.rmtree(run_tmp, ignore_errors=True)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
