"""Run one cell of the benchmark once and print its result.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for (`workloads/<cell>.json`). The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), `device`, with
--trace 1 `breakdown`, and last `checks`, each number compared with its
limit; the same numbers are the last lines of standard error. Without the
cards, without the program (`setok_tpu_torch`), or with JAX or the JAX
package loaded once the window has closed, it exits non-zero and prints
no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "setok_tpu")
HERE = Path(__file__).resolve().parent


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is a forbidden one."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell_file = HERE / "workloads" / f"{args.workload}.json"
    if not cell_file.is_file():
        say(f"no workload named {args.workload!r}")
        return 2
    chips = json.loads(cell_file.read_text())["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"{args.workload} needs {chips} CUDA card(s); "
            f"available: {torch.cuda.device_count()}")
        return 2
    sys.path.insert(0, str(HERE.parent))
    try:
        import setok_tpu_torch  # noqa: F401
    except ImportError as err:
        say(f"the program is missing: {err}")
        return 2
    from h100_bench import harness

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START, device="cuda",
                         log=say)
    found = forbidden_modules()
    if found:
        say(f"loaded in this process: {', '.join(found)}")
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": result.pop("_peak")}
    record = result.pop("_record")
    out = {"correct": result["correct"], "attempted": result["attempted"],
           "failed": result["failed"], "metrics": result["metrics"],
           "device": device}
    if record is not None:
        device.update(busy_s=record["busy_s"], window_s=record["window_s"])
        out["breakdown"] = {"device_ops": record["device_ops"],
                            "idle_gaps": record["idle_gaps"]}
        say(f"spans: {json.dumps(record['spans'])}")
        say(f"calls: {json.dumps(record['calls'])} row 1 launches "
            f"{record['cluster_launches']} batches {record['batches']}")
    out["checks"] = result["checks"]
    for name, c in result["checks"].items():
        say(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
