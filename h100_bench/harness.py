"""One run of one cell: set-up, the measured window, the check.

Everything that belongs to one cell, configuration, traffic mix, traffic
mode or per-layer metric sits in a file of its own under this folder,
found by name:

    workloads/<cell>.json     config, traffic, chips, why, limits, controls
    configs/<config>.json     the sizes as run, dtypes, source, cuts
    traffic/<traffic>.json    mode, batch, batches in flight, image pool,
                              sampled batches, quant8
    modes/<mode>.py           the entry it drives, the outputs it copies,
                              the numbers it judges, its count of operations
    metrics/<metric>.py       a per-layer reader of the traced run

The closed loop keeps `in_flight` batches queued on the device: batch i+1
is enqueued before the host waits for batch i's outputs. A batch is
timed from the moment its upload is enqueued to the moment its outputs
are in host memory (pinned buffers, a CUDA event). Set-up (imports, the
model, weights drawn on the device, the image pool, the warm-up of every
shape) ends before the window opens.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from collections import deque
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from h100_bench import check, images, trace, weights
from h100_bench.reference import setok_ref

ROOT = Path(__file__).resolve().parent
TRACE_SECONDS = 4.0          # the profiled part of a --trace 1 run
WARM_BATCHES = 4
CHECK_BLOCK = 16             # images a reference block holds


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind}"
                                f" named {name!r}: {path}")
    return json.loads(path.read_text())


def load_module(root: Path, kind: str, name: str):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def list_names(root: Path, kind: str, suffix: str = ".json") -> list:
    """The names of a kind's files."""
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(
        f"*{suffix}"))


class Cell:
    """A cell's files, read by name."""

    def __init__(self, name: str, root: Path = ROOT):
        self.name, self.root = name, root
        self.cell = load_json(root, "workloads", name)
        self.config = load_json(root, "configs", self.cell["config"])
        self.traffic = load_json(root, "traffic", self.cell["traffic"])
        self.mode = load_module(root, "modes", self.traffic["mode"])

    def port_configs(self):
        """The port's TokenizerConfig and DetokenizerConfig, built from the
        configuration file's sizes."""
        from setok_tpu_torch.config import (DetokenizerConfig,
                                            TokenizerConfig, ViTConfig)
        c = self.config
        tok = TokenizerConfig(vit=ViTConfig(**c["vit"]), **c["tokenizer"])
        return tok, DetokenizerConfig(**c["detokenizer"])

    def dtypes(self):
        return (getattr(torch, self.config["param_dtype"]),
                getattr(torch, self.config["compute_dtype"]))

    @property
    def image_size(self) -> int:
        return self.config["vit"]["image_size"]


def program_counters() -> dict:
    """The port's own counters: calls of each int8 kernel and row 1's
    launches, since import."""
    from setok_tpu_torch.kernels import (cluster_dpc, fused_attention_int8,
                                         fused_bert_attention_int8, fused_mlp,
                                         fused_sublayer, quant_matmul)
    calls = {}
    for mod in (fused_sublayer, fused_bert_attention_int8, fused_mlp,
                fused_attention_int8, quant_matmul):
        calls.update(mod.CALLS)
    return {"calls": calls, "cluster_launches": cluster_dpc.LAUNCHES}


def counter_delta(before: dict, after: dict) -> dict:
    return {"calls": {k: after["calls"][k] - before["calls"].get(k, 0)
                      for k in after["calls"]},
            "cluster_launches": after["cluster_launches"]
            - before["cluster_launches"]}


def keep_cluster(tokenizer, store: dict) -> None:
    """Wrap `tokenizer.cluster` so that each call leaves its scores in
    `store`, and, where `store["keep"]` is set, a copy of its input features
    in pinned host memory, enqueued on the stream (so the program's device
    memory holds them no longer than it would)."""
    inner = tokenizer.cluster

    def cluster(x, **kw):
        res = inner(x, **kw)
        store["score"] = res.score
        if store.get("keep"):
            host = x
            if x.is_cuda:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
            store["features"] = host
        return res

    tokenizer.cluster = cluster


def build_program(cell: Cell, seed: int, device, quant8: Optional[bool] = None):
    """The program of a cell with its weights drawn from `seed`."""
    tok_cfg, det_cfg = cell.port_configs()
    param_dtype, dtype = cell.dtypes()
    q8 = cell.traffic["quant8"] if quant8 is None else quant8
    model = cell.mode.build(tok_cfg, det_cfg, dtype=dtype,
                            param_dtype=param_dtype, device=device,
                            quant8=q8)
    load_weights(cell, model, seed, device)
    return model


def load_weights(cell: Cell, model, seed: int, device) -> None:
    spec = setok_ref.param_spec(cell.config)
    param_dtype, _ = cell.dtypes()
    for part, module in cell.mode.parts(model).items():
        weights.load_into(module, spec[part], seed, part, param_dtype, device)


class Loop:
    """The closed loop over an image pool: `in_flight` batches queued,
    outputs copied into pinned host buffers, one CUDA event a batch.
    `forward(images, keep)` enqueues a batch; with `keep` its outputs hold
    the checked ones too (an output already in host memory is taken as it
    is: its copy is enqueued before the batch's event)."""

    def __init__(self, forward: Callable, pool: list, device, in_flight: int,
                 always, checked):
        self.forward, self.pool, self.device = forward, pool, device
        self.in_flight = in_flight
        self.always, self.checked = tuple(always), tuple(checked)
        self.cuda = torch.device(device).type == "cuda"
        self.queue = deque()
        self.slots = None

    def _host(self, outs, names):
        return {k: torch.empty(outs[k].shape, dtype=outs[k].dtype,
                               pin_memory=self.cuda) for k in names}

    def enqueue(self, i: int, keep: bool) -> None:
        t_enq = time.perf_counter()
        x = self.pool[i % len(self.pool)].to(self.device, non_blocking=True)
        outs = self.forward(x, keep)
        if self.slots is None:
            # pinned buffers, one set a batch in flight
            self.slots = [self._host(outs, self.always)
                          for _ in range(self.in_flight)]
        if keep:
            on_host = {k: outs[k] for k in self.always + self.checked
                       if outs[k].device.type == "cpu"}
            host = dict(self._host(outs, [k for k in self.always
                                          + self.checked if k not in on_host]))
        else:
            on_host, host = {}, self.slots[i % self.in_flight]
        for k, buf in host.items():
            buf.copy_(outs[k], non_blocking=True)
        host.update(on_host)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        self.queue.append((i, t_enq, event, host if keep else None))

    def pop(self):
        """Wait for the oldest batch: (index, enqueued, done, kept
        outputs or None)."""
        i, t_enq, event, kept = self.queue.popleft()
        if event is not None:
            event.synchronize()
        return i, t_enq, time.perf_counter(), kept

    def run(self, start: int, seconds: float, keep_at=()):
        """Batches from `start` until `seconds` have passed, then drain;
        a batch enqueued at or after each time in `keep_at` (seconds into
        the window; one batch a time) keeps its checked outputs. Returns
        (completions [(index, enqueued, done)], kept {index: outputs},
        window start, window end)."""
        done, kept = [], {}
        pending = sorted(keep_at)
        t0 = time.perf_counter()
        t_end = t0 + seconds
        i = start
        while True:
            while len(self.queue) < self.in_flight:
                now = time.perf_counter()
                if now >= t_end:
                    break
                keep = bool(pending) and now - t0 >= pending[0]
                if keep:
                    pending.pop(0)
                self.enqueue(i, keep)
                i += 1
            if not self.queue:
                break
            j, t_enq, t_done, out = self.pop()
            done.append((j, t_enq, t_done))
            if out is not None:
                kept[j] = out
        return done, kept, t0, t_end

    def drain(self):
        while self.queue:
            self.pop()


def sample_times(seed: int, seconds: float, k: int) -> list:
    """k times in the window, drawn from the seed, at which a batch is
    sampled for the check."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 11]))
    return sorted(seconds * rng.uniform(0.05, 0.8, size=k))


def per_layer_metrics(cell: Cell, record: dict) -> dict:
    """The per-layer metrics that BENCHMARK.json, beside this folder, names
    for this cell, each read by metrics/<name>.py; one that finds nothing
    is left out."""
    bench = json.loads((cell.root.parent / "BENCHMARK.json").read_text())
    out = {}
    for m in bench["per_layer"]:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
        mod = load_module(cell.root, "metrics", m["name"])
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": mod.UNIT}
    return out


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, *,
        t_start: float, device="cuda", root: Path = ROOT,
        forward: Optional[Callable] = None, log=print) -> dict:
    """One run of a cell. Returns the result (without `device`'s
    card fields when on the CPU). `forward` replaces the mode's forward
    (the tests plant faults with it)."""
    cell = Cell(cell_name, root)
    tr, mode = cell.traffic, cell.mode
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    marks = [("imports and the CUDA context", time.perf_counter())]
    model = build_program(cell, seed, device)
    marks.append(("model and weights", time.perf_counter()))
    fwd = forward or (lambda x, keep: mode.forward(model, x, keep))
    pool = images.image_pool(seed, tr["pool_batches"], tr["batch"],
                             cell.image_size, pin=cuda)
    marks.append(("image pool", time.perf_counter()))
    loop = Loop(fwd, pool, device, tr["in_flight"], mode.ALWAYS, mode.CHECKED)
    # warm-up: every shape of the window, through the window's own loop
    for i in range(WARM_BATCHES):
        loop.enqueue(i, keep=i == 0)
        if len(loop.queue) >= loop.in_flight:
            loop.pop()
    loop.drain()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    parts, prev = [], t_start
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f} s")
        prev = t
    log("set-up: " + ", ".join(parts))

    start = WARM_BATCHES
    window = min(seconds, TRACE_SECONDS) if trace_on else seconds
    keep = sample_times(seed, window, tr["sample_batches"])
    record = None
    if trace_on:
        record = traced_window(cell, model, loop, start, window, keep)
        done, kept = record.pop("done"), record.pop("kept")
    else:
        done, kept, t0, t_end = loop.run(start, window, keep)
    if not kept:
        raise RuntimeError("no sampled batch completed")
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    result = {"attempted": len(done), "failed": 0}
    if trace_on:
        result["metrics"] = per_layer_metrics(cell, record)
    else:
        # the window closes at the first completion at or after `seconds`,
        # so that it holds whole batches: the batches completed by then,
        # over the time from its opening to then
        k = next(j for j, d in enumerate(done) if d[2] >= t_end)
        lat = [t_done - t_enq for _, t_enq, t_done in done[:k + 1]]
        span = done[k][2] - t0
        result["metrics"] = {
            "images_per_s": {"value": len(lat) * tr["batch"] / span,
                             "unit": "images/s"},
            "batch_ms_p95": {"value": float(np.percentile(lat, 95)) * 1e3,
                             "unit": "ms"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        result["attempted"] = len(lat)
        log(f"window: {len(lat)} batches of {tr['batch']} in {span} s, "
            f"{len(done) - len(lat)} drained after it")
    result["_peak"] = peak
    result["_record"] = record

    # the program's state goes before the reference runs
    del model, fwd, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    batches = [(pool[i % len(pool)].to(device), kept[i]) for i in sorted(kept)]
    numbers = judge(cell, seed, batches, device, log=log)
    result["checks"] = numbers
    result["correct"] = all(v["value"] <= v["limit"] for v in numbers.values())
    return result


def judge(cell: Cell, seed: int, batches, device, log=print) -> dict:
    """{number: {"value", "limit"}} of the sampled batches."""
    ref = check.Reference(cell.config, seed, cell.mode.PARTS, device)
    worst = check.judge_batches(lambda x, got: cell.mode.judge(ref, x, got),
                                batches, CHECK_BLOCK)
    log(f"numbers: {json.dumps(worst)}")
    limits = cell.cell["limits"]
    return {k: {"value": worst[k], "limit": limits[k]} for k in limits}


def traced_window(cell: Cell, model, loop: Loop, start: int, seconds: float,
                  keep) -> dict:
    """The window under torch.profiler, whole batches only (drained before
    and after), with the spans around the calls of each part of the model
    and the program's counters read before and after."""
    from torch.profiler import ProfilerActivity, profile, record_function

    hooks = []
    for part, module in cell.mode.parts(model).items():
        def pre(m, _args, name=part):
            m.__dict__["_h100_span"] = rf = record_function(
                trace.SPAN_PREFIX + name)
            rf.__enter__()

        def post(m, _args, _out):
            m.__dict__.pop("_h100_span").__exit__(None, None, None)

        hooks += [module.register_forward_pre_hook(pre),
                  module.register_forward_hook(post)]
    loop.drain()
    if torch.device(loop.device).type == "cuda":
        torch.cuda.synchronize()
    before = program_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done, kept, _, _ = loop.run(start, seconds, keep)
        if torch.device(loop.device).type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    after = program_counters()
    for h in hooks:
        h.remove()
    record = trace.reduce(prof, window_s)
    record.update(counter_delta(before, after))
    record.update(done=done, kept=kept, batches=len(done),
                  batch=cell.traffic["batch"], config=cell.config,
                  step_flops=cell.mode.flops(cell.config),
                  quant8=cell.traffic["quant8"])
    return record
