"""The benchmark's harness on the CPU: its files, its copies, its check.

    python -m pytest -q h100_bench/tests

  * BENCHMARK.json keeps the contract's names, units and cross references,
    and agrees with the files the harness reads by name;
  * the frozen copies (bounds, image generator) equal their originals at
    the path shapes, and the FLOP count equals PyTorch's count of the
    port's products;
  * nothing that run.py or the reference imports is JAX or the JAX
    package, and the reference imports nothing of the port;
  * a cell added as files in another folder is listed and runs;
  * the check fails a run whose outputs are broken (one answer altered,
    half the batch left out) and the low-precision controls, at a size a
    test holds, against the limits of the cells (the program's own int8
    form at the cell's size, on the card: marker `cuda`).
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from h100_bench import check, harness, images, trace
from h100_bench.roofline import bounds, flops
from h100_bench.tests.test_h100bench_reference import tiny_config

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


def test_the_metric_files_declare_what_benchmark_json_says():
    assert sorted(m["name"] for m in BENCH["per_layer"]) == \
        harness.list_names(ROOT, "metrics", ".py")
    for m in BENCH["per_layer"]:
        mod = harness.load_module(ROOT, "metrics", m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"]), m["name"]


def test_cells_and_configurations_agree_with_their_files():
    from setok_tpu_torch import config as C
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert cell.cell[k] == w[k], (w["name"], k)
        assert set(cell.cell["limits"]) == set(cell.mode.NUMBERS)
        assert all(v > 0 for v in cell.cell["limits"].values())
        controls = cell.cell["controls"]
        assert set(controls) <= set(check.CONTROLS)
        assert sorted(n for ns in controls.values() for n in ns) == \
            sorted(cell.mode.NUMBERS)
        tok, det = cell.port_configs()
        preset = cell.config["preset"]
        assert tok == getattr(C, preset["tokenizer"])()
        assert det == getattr(C, preset["detokenizer"])()
    for c in BENCH["configs"]:
        data = json.loads((REPO / c["file"]).read_text())
        assert (data["name"], data["source"], data["reduced"]) == (
            c["name"], c["source"], c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))


def test_cluster_bound_equals_chip_smoke():
    import chip_smoke
    for b, n, c in ((64, 256, 768), (8, 729, 4096), (32, 729, 4096),
                    (16, 1296, 768)):
        assert bounds.cluster_bound_ms(b, n, c) == \
            chip_smoke.cluster_bound(b, n, c)["bound_ms"]


def test_int8_bound_equals_chip_smoke_at_the_path_shapes():
    import chip_smoke
    from setok_tpu_torch.kernels.quant import QuantizedWeight
    cfg = json.loads((ROOT / "configs" / "setok-base256.json").read_text())
    seen = set()
    for name, b, n, c, hidden, m in bounds.int8_sublayer_calls(cfg, 64):
        if (name, n, c, hidden, m) in seen:
            continue
        seen.add((name, n, c, hidden, m))
        x = torch.empty(b, n, c, device="meta")
        w = QuantizedWeight(torch.empty(hidden, c, device="meta"), None)
        if name == "fused_bert_attention_int8":
            kv = x if m is None else torch.empty(b, m, c, device="meta")
            args = (x, kv)
        elif name == "mlp_sublayer_int8":
            args = (x, None, None, w)
        else:
            args = (x, w)
        assert bounds.int8_bound_ms(name, b, n, c, hidden, m) == \
            chip_smoke.int8_bound(name, args), (name, n, c, m)
    assert len(seen) == 7


def test_image_generator_equals_the_port_generator():
    import numpy as np
    from setok_tpu_torch.utils import synthetic
    for size in (32, 256, 384):
        a = images.structured_image(size, np.random.RandomState(7))
        b = synthetic.structured_image(size, np.random.RandomState(7))
        assert np.array_equal(a, b)
    pool = images.image_pool(2 ** 40 + 3, 2, 3, 32, False)
    again = images.image_pool(2 ** 40 + 3, 2, 3, 32, False)
    assert all(torch.equal(p, q) for p, q in zip(pool, again))
    assert not torch.equal(pool[0][0], pool[0][1])


@pytest.mark.parametrize("threshold", [0.55, 1e9])
def test_flop_count_equals_torch_count_of_the_port(threshold):
    """PyTorch's count of the port's float forward is the benchmark's count
    plus the one-hot product that the port computes the cluster mean with
    (2 N k_max C), which the count leaves out."""
    from torch.utils.flop_counter import FlopCounterMode
    from h100_bench.tests.test_h100bench_reference import port_model
    cfg = tiny_config(threshold=threshold)
    model = port_model(cfg, 4)
    x = images.image_pool(4, 1, 2, cfg["vit"]["image_size"], False)[0]
    model.requires_grad_(False)
    counter = FlopCounterMode(display=False)
    with counter:
        model(x)
    ours = harness.load_module(ROOT, "modes", "recon").flops(cfg)
    t, v = cfg["tokenizer"], cfg["vit"]
    n = (v["image_size"] // v["patch_size"]) ** 2
    extra = 2.0 * n * t["k_max"] * t["hidden_dim"]
    assert counter.get_total_flops() == x.shape[0] * (
        ours["int8"] + ours["float"] + extra)


def _imported_top_levels(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_harness_runs_imports_jax_or_the_jax_package():
    code = ("import runpy, sys\nsys.argv = ['x']\n"
            "from h100_bench import harness, check, trace, calibrate\n"
            "from pathlib import Path\n"
            "for kind in ('modes', 'metrics'):\n"
            "    for p in sorted((harness.ROOT / kind).glob('*.py')):\n"
            "        harness.load_module(harness.ROOT, kind, p.stem)\n"
            "harness.program_counters()\n"
            "import setok_tpu_torch.models.setok, runpy\n"
            "runpy.run_path('h100_bench/run.py', run_name='not_main')\n")
    names = _imported_top_levels(code)
    assert "setok_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "setok_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    names = _imported_top_levels(
        "from h100_bench import check, weights, images\n"
        "from h100_bench.reference import setok_ref\n"
        "from h100_bench.roofline import bounds, flops\n")
    assert not names & {"setok_tpu_torch", "setok_tpu", "jax", "flax"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import runpy
    run = runpy.run_path(str(ROOT / "run.py"), run_name="not_main")
    monkeypatch.setitem(sys.modules, "setok_tpu_torch_extra",
                        types.ModuleType("setok_tpu_torch_extra"))
    for name in ("jax", "flax", "setok_tpu", "jaxlib"):
        sys.modules.pop(name, None)
    assert run["forbidden_modules"]() == []
    monkeypatch.setitem(sys.modules, "setok_tpu.models",
                        types.ModuleType("setok_tpu.models"))
    assert run["forbidden_modules"]() == ["setok_tpu"]


def test_run_without_a_card_or_without_the_program_prints_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


# ---------------------------------------------------------------------------
# a cell added as files, run on the CPU


def tiny_root(tmp_path: Path, traffic: dict, limits_of: str) -> Path:
    """A copy of the benchmark folder with a tiny configuration, a traffic
    mix and a cell `tiny-<mode>` added as files, and a BENCHMARK.json beside
    it that adds the cell to every per-layer metric; the cell's limits and
    controls are those of the real cell `limits_of`."""
    root = tmp_path / "h100_bench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    (root / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (root / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    real = json.loads((ROOT / "workloads" / f"{limits_of}.json").read_text())
    name = f"tiny-{traffic['mode']}"
    cell = dict(real, config="tiny", traffic="tiny", why="a test cell")
    (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": name, "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "a test cell"})
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + [name]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


TRAFFIC = {"quant8": False, "batch": 4, "in_flight": 2, "pool_batches": 2,
           "sample_batches": 2}


def run_tiny(root, mode, trace_on=False, forward=None, seed=2 ** 31 + 5):
    return harness.run(f"tiny-{mode}", seed, 0.3, trace_on,
                       t_start=time.perf_counter(), device="cpu", root=root,
                       forward=forward, log=lambda msg: None)


@pytest.mark.parametrize("mode,cell", [("recon", "base256-int8-recon"),
                                       ("tokenize", "so400m-bf16-tokenize")])
def test_a_cell_added_as_files_is_listed_and_runs(tmp_path, mode, cell):
    root = tiny_root(tmp_path, dict(TRAFFIC, mode=mode), cell)
    assert f"tiny-{mode}" in harness.list_names(root, "workloads")
    result = run_tiny(root, mode)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"images_per_s", "batch_ms_p95",
                                      "peak_mem_gib", "setup_s"}
    assert result["attempted"] > 0
    traced = run_tiny(root, mode, trace_on=True)
    assert traced["correct"]
    rec = traced["_record"]
    # the CPU has no device timeline: no busy time and no span ranges
    assert rec["batches"] > 0 and rec["busy_s"] == 0 and rec["spans"] == {}
    assert "mfu" in traced["metrics"]


def _faulty(model, mode, fault):
    """The mode's forward with one fault planted where the outputs are
    produced: one token (and one image) altered, one token put in another
    cluster, or half of the batch left out (its outputs those of the other
    half)."""
    def forward(x, keep=False):
        out = {k: v.clone() for k, v in mode.forward(model, x, keep).items()}
        if fault == "token":
            out["tokens"][0, 0] = -out["tokens"][0, 0]
            if "recon" in out:
                out["recon"][0] = -out["recon"][0]
        elif fault == "cluster":
            out["idx_cluster"][0, 0] += 1
        elif fault == "half":
            h = x.shape[0] // 2
            for v in out.values():
                v[h:] = v[:h]
        return out
    return forward


MODE_CELLS = [(harness.Cell(c).traffic["mode"], c) for c in CELLS]


@pytest.mark.parametrize("fault", ["token", "cluster", "half"])
@pytest.mark.parametrize("mode,cell", MODE_CELLS)
def test_broken_outputs_make_correct_false(tmp_path, mode, cell, fault):
    root = tiny_root(tmp_path, dict(TRAFFIC, mode=mode), cell)
    c = harness.Cell(f"tiny-{mode}", root)
    model = harness.build_program(c, 2 ** 31 + 5, "cpu")
    result = run_tiny(root, mode, forward=_faulty(model, c.mode, fault))
    assert not result["correct"], result["checks"]


def _control_forward(c, control, seed):
    """The control's forward in the program's place, at the tiny cell `c`:
    the reference at w4a8, or the program with its clustering redone over
    float8 features."""
    if control == "w4a8":
        low = check.Reference(c.config, seed, c.mode.PARTS, "cpu",
                              quant="w4a8")
        return lambda x, keep: low.outputs(x)
    model = harness.build_program(c, seed, "cpu")
    t = c.config["tokenizer"]
    return lambda x, keep: check.fp8_clustering(
        t, c.mode.forward(model, x, True))


CONTROLS = {cell: harness.Cell(cell).cell["controls"] for cell in CELLS}


@pytest.mark.parametrize("mode,cell,control", [
    (mode, cell, control) for mode, cell in MODE_CELLS
    for control in CONTROLS[cell] if control != "quant8"])
def test_the_low_precision_controls_fail_the_cells_limits(tmp_path, mode,
                                                          cell, control):
    """Each control of each cell that departs from the program at any size
    (the reference at w4a8, the clustering over float8 features), at a tiny
    size on the CPU, against the cell's limits, its outputs judged as a run
    judges the program's: it fails one of the numbers that it is the
    control of. The program's own int8 form departs by the rounding of its
    depth and width, so it is held at the cell's own size, on the card
    (the next test)."""
    root = tiny_root(tmp_path, dict(TRAFFIC, mode=mode), cell)
    c = harness.Cell(f"tiny-{mode}", root)
    seed = 2 ** 31 + 99
    result = run_tiny(root, mode, forward=_control_forward(c, control, seed),
                      seed=seed)
    failed = {k for k, v in result["checks"].items()
              if v["value"] > v["limit"]}
    assert failed & set(c.cell["controls"][control]), result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c for c in CELLS if "quant8" in CONTROLS[c]])
def test_the_int8_form_fails_the_cells_limits_on_the_card(cell):
    """The "quant8" control (the program's own int8 form) at the cell's own
    size and load, on a seed of its own: it fails one of the numbers that
    it is the control of."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from h100_bench import calibrate
    c = harness.Cell(cell)
    numbers = c.cell["controls"]["quant8"]
    c.cell = dict(c.cell, controls={"quant8": numbers})
    got = {}
    calibrate.readings(c, [], [2 ** 31 + 123], 3.0, "cuda",
                       lambda kind, seed, read, t0: got.update({kind: read}))
    limits = c.cell["limits"]
    assert any(got["quant8"][n] > limits[n] for n in numbers), got


# ---------------------------------------------------------------------------
# the trace's reduction and the readers


def test_busy_time_is_the_union_of_device_intervals():
    merged = trace._merge([(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)])
    assert merged == [[0, 12], [20, 30], [40, 41]]
    assert trace._busy_within(merged, [(3, 22), (29, 45)]) == 9 + 2 + 1 + 1


def test_kernel_names_reduce_to_their_functions():
    from h100_bench.roofline import kernel_names as k
    assert k.base_name("void (anonymous namespace)::attn_mma_kernel<"
                       "__nv_bfloat16, 64>(float const*)") == "attn_mma_kernel"
    assert k.base_name("void wgmma_gemm_kernel<(BSrc)0, BiasEpi>(CUtensorMap"
                       ")") == "wgmma_gemm_kernel"
    assert k.base_name("rows_kernel(float const*, int)") == "rows_kernel"
    assert k.base_name("void density_rows_kernel<true>(float const*)") == \
        "density_rows_kernel"


def test_rooflines_read_from_a_record():
    cfg = json.loads((ROOT / "configs" / "setok-base256.json").read_text())
    calls = bounds.int8_sublayer_calls(cfg, 64)
    bound_us = 1e3 * sum(bounds.int8_bound_ms(*c)[0] for c in calls)
    rec = {"config": cfg, "entry": "recon", "quant8": True, "batch": 64,
           "batches": 2, "window_s": 1.0, "busy_s": 0.9,
           "calls": {"attn_sublayer_int8": 64, "mlp_sublayer_int8": 60,
                     "fused_bert_attention_int8": 18,
                     "mlp_postnorm_int8": 12, "quant_matmul": 0},
           "cluster_launches": 4,
           "kernels": [("void wgmma_gemm_kernel<0>(int)", 0, 8 * bound_us),
                       ("gram_kernel(float const*)", 0, 400.0),
                       ("ampere_sgemm_128x64_nn", 0, 1000.0)],
           "spans": {"tokenizer": {"count": 2, "device_us": 3000.0}},
           "step_flops": harness.load_module(ROOT, "modes", "recon").flops(
               cfg)}
    read = {n: harness.load_module(ROOT, "metrics", n).read(rec)
            for n in harness.list_names(ROOT, "metrics", ".py")}
    assert read["int8_sublayers_roofline"] == pytest.approx(100 / 4)
    assert read["cluster_dpc_roofline"] == pytest.approx(
        100 * 2 * bounds.cluster_bound_ms(64, 256, 768) * 1e3 / 400)
    assert read["device_idle_share"] == pytest.approx(10.0)
    assert read["tokenizer.device_ms"] == pytest.approx(1.5)
    assert read["detokenizer.device_ms"] is None
    rec["calls"]["quant_matmul"] = 1
    assert harness.load_module(ROOT, "metrics", "int8_sublayers_roofline"
                               ).read(rec) is None
