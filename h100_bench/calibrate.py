"""The readings that a cell's limits are set from, on the card.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

In one process: for each seed of `--seeds`, the program's weights and
images are drawn from it, the cell's closed loop runs a short window at
the cell's own batch and load, and its sampled batches are judged as a run
judges them (the mode's `judge`). For each seed of `--control-seeds`, each
control that the cell's file names (`controls`, check.py) is judged the
same way in the program's place:

  * "quant8": the program's own int8 form (`quant8=True`), its own window;
  * "w4a8": the plain reference, its block linears on int4 weights and
    int8 inputs, over the images of the program's sampled batches;
  * "fp8-features": the program's sampled outputs with their clustering
    replaced by the reference's over their features rounded to float8.

Prints one JSON line a reading, then for each number the largest reading
of the program and the smallest of each control. The benchmark's runs do
not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from h100_bench import check, harness, images  # noqa: E402


def window_batches(cell, model, seed: int, seconds: float, device):
    """[(images, outputs)] of the sampled batches of a short window of the
    cell's loop over `model`, whose weights are those of `seed`."""
    tr = cell.traffic
    pool = images.image_pool(seed, tr["pool_batches"], tr["batch"],
                             cell.image_size, pin=torch.device(device).type
                             == "cuda")
    loop = harness.Loop(lambda x, keep: cell.mode.forward(model, x, keep),
                        pool, device, tr["in_flight"], cell.mode.ALWAYS,
                        cell.mode.CHECKED)
    for i in range(harness.WARM_BATCHES):
        loop.enqueue(i, keep=False)
        if len(loop.queue) >= loop.in_flight:
            loop.pop()
    loop.drain()
    _, kept, _, _ = loop.run(harness.WARM_BATCHES, seconds,
                             harness.sample_times(seed, seconds,
                                                  tr["sample_batches"]))
    return [(pool[i % len(pool)].to(device), kept[i]) for i in sorted(kept)]


def in_place(cell, control: str, seed: int, batches, device) -> list:
    """The "w4a8" or "fp8-features" control's outputs in the place of the
    program's sampled `batches`."""
    t = cell.config["tokenizer"]
    if control == "fp8-features":
        return [(x, check.fp8_clustering(t, {k: v.to(device) for k, v in
                                             got.items()}))
                for x, got in batches]
    low = check.Reference(cell.config, seed, cell.mode.PARTS, device,
                          quant=control)
    placed = []
    for x, _ in batches:
        outs = {}
        for s in range(0, x.shape[0], harness.CHECK_BLOCK):
            for k, v in low.outputs(x[s:s + harness.CHECK_BLOCK]).items():
                outs.setdefault(k, []).append(v)
        placed.append((x, {k: torch.cat(v) for k, v in outs.items()}))
    return placed


def readings(cell, seeds, control_seeds, seconds: float, device, emit):
    """Judge the program on `seeds` and each of the cell's controls on
    `control_seeds`; `emit(kind, seed, numbers, t0)` takes each reading."""
    def judged(seed, batches):
        ref = check.Reference(cell.config, seed, cell.mode.PARTS, device)
        return check.judge_batches(
            lambda x, got: cell.mode.judge(ref, x, got), batches,
            harness.CHECK_BLOCK)

    controls = list(cell.cell["controls"])
    model = None
    for seed in list(seeds) + [s for s in control_seeds if s not in seeds]:
        t0 = time.perf_counter()
        if model is None:
            model = harness.build_program(cell, seed, device)
        else:
            harness.load_weights(cell, model, seed, device)
        batches = window_batches(cell, model, seed, seconds, device)
        if seed in seeds:
            emit("program", seed, judged(seed, batches), t0)
        if seed in control_seeds:
            for control in controls:
                if control != "quant8":
                    t0 = time.perf_counter()
                    emit(control, seed, judged(seed, in_place(
                        cell, control, seed, batches, device)), t0)
    if "quant8" in controls and control_seeds:
        del model
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        model = None
        for seed in control_seeds:
            t0 = time.perf_counter()
            if model is None:
                model = harness.build_program(cell, seed, device, quant8=True)
            else:
                harness.load_weights(cell, model, seed, device)
            emit("quant8", seed, judged(seed, window_batches(
                cell, model, seed, seconds, device)), t0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    cell = harness.Cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    got = {}

    def emit(kind, seed, numbers, t0):
        got.setdefault(kind, []).append(numbers)
        print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                          "s": round(time.perf_counter() - t0, 1)}),
              flush=True)

    readings(cell, seeds, control_seeds, args.seconds, "cuda", emit)
    summary = {}
    for name in cell.mode.NUMBERS:
        summary[name] = {"program_max": max(r[name] for r in got["program"])}
        for kind in cell.cell["controls"]:
            summary[name][f"{kind}_min"] = min(
                (r[name] for r in got.get(kind, [])), default=None)
    print(json.dumps({"summary": summary,
                      "device": torch.cuda.get_device_name(0),
                      "s": round(time.perf_counter() - T_START, 1)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
