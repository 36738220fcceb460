"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in `BENCHMARK.json` names its
configuration and traffic mix; `portbench/harness/cell.py` finds their
files. The run builds the program under test (`tunevlseg_torch`) with
weights and inputs drawn from the seed on the card, warms up the cell's own
shapes (set-up, `setup_s`), measures for `--seconds`, and then holds what
the timed path produced against the plain reference (`correct`). With
`--trace 1` it reports the per-layer metrics, read from a short traced
window after the measured one, and the `breakdown`. The last line of
standard output is the result; the compared numbers and their limits are
also the last lines of standard error.

It exits with code 2 and prints no result without a CUDA card (or with
fewer than the cell's), and with code 3 if JAX, flax or the JAX package is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tunevlseg_tpu")


def prepare_environment() -> None:
    """Caches inside the checkout, at fixed paths; no library loads JAX."""
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose whole top-level name is JAX's, jaxlib's,
    flax's or the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """One run; returns the result."""
    args = parse(argv)
    prepare_environment()
    from portbench.harness import cell as cell_lib, report
    from portbench.harness import device as dev
    cell = cell_lib.load(args.workload, ROOT)
    device = dev.require(cell.chips)
    run = cell.loop().run(cell, args.seed, args.seconds, bool(args.trace), T0, device)
    return report.result(cell, run, bool(args.trace), device)


def cli() -> int:
    result = main()
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    from portbench.harness import report
    report.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
