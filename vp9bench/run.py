"""Run one cell of the benchmark and print its result as the last line
of standard output (one JSON object), the compared numbers beside their
limits as the last lines of standard error.

    python vp9bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout that holds the port
(ffmpeg_hybrid_tpu_torch); needs as many CUDA devices as the cell asks
for, and exits non-zero without a result otherwise.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from vp9bench import registry
    try:
        bench = registry.benchmark(ROOT)
        w, _e, _p = registry.cell(bench, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"[vp9bench] {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"[vp9bench] the cell needs {w['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import ffmpeg_hybrid_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"[vp9bench] the port is not in this checkout: {e}",
              file=sys.stderr)
        return 4

    from vp9bench import harness
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"[vp9bench] loaded in this process: {', '.join(found)}; "
              "the benchmark runs without JAX and the JAX package",
              file=sys.stderr)
        return 5
    for name, d in result["checks"].items():
        print(f"[vp9bench] check {name}: {d['value']} (limit {d['limit']})",
              file=sys.stderr)
    print(f"[vp9bench] correct: {result['correct']}", file=sys.stderr,
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
