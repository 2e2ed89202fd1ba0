"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the last line of standard output is the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, in one JSON object with
`correct`, `attempted`, `failed`, `metrics`, `device` and, last, `checks`
(each number compared with its limit, also the last lines of standard
error). An earlier line gives the host's cores and threads, and one the
host's launch speed, its pure-Python speed and the card's clock and power
around the window, which is also kept in `portbench/runs/`. `--control
tf32` runs the control of `correct`: the program's f32 matrix products in
TF32.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2; so it does when a module of JAX or of the JAX package
is loaded once the window has closed (exit 3).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    # the checkout's root, not this directory, heads the import path: the
    # benchmark's modules are imported as `portbench.*`
    sys.path[0] = str(ROOT)


def pin_threads(workload: str) -> int:
    """Set the CPU threads the cell's configuration states, and the build
    caches inside the checkout, before torch is imported."""
    from portbench import manifest

    n = int(manifest.load_cell(workload, ROOT)["config"]["threads"])
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(n)
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    args = ap.parse_args(argv)
    threads = pin_threads(args.workload)
    print(f"cores: {len(os.sched_getaffinity(0))} threads: {threads}", flush=True)

    import torch

    torch.set_num_threads(threads)
    torch.set_num_interop_threads(threads)
    from portbench import harness

    try:
        result, lines, host = harness.run_cell(args.workload, args.seed, args.seconds,
                                               bool(args.trace), ROOT, control=args.control,
                                               t_start=T_START)
    except harness.RunError as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    banned = harness.banned_modules()
    if banned:
        print(f"no result: modules of JAX or the JAX package are loaded: {banned}",
              file=sys.stderr)
        return 3
    print("host: " + json.dumps(host), flush=True)
    runs = ROOT / "portbench" / "runs"
    runs.mkdir(exist_ok=True)
    tag = f"{args.workload}.seed{args.seed}.trace{args.trace}"
    (runs / f"{tag}{'.' + args.control if args.control else ''}.json").write_text(
        json.dumps(host) + "\n")
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
