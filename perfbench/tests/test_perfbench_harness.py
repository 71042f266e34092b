"""CPU tests of the benchmark: every cell's command at its toy size, the
window rule, the work counts of the rooflines, the import check, the
reference against autograd, and the comparison that decides ``correct``
against its control and the faults a cell can have."""

from __future__ import annotations

import dataclasses
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness, scenes
from perfbench.reference import ba

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cmd(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=600)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_command_prints_a_result_line(workload, trace):
    p = run_cmd("--workload", workload, "--seed", "3000000017", "--seconds", "0.2",
                "--trace", str(trace), "--device", "cpu", "--toy")
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    want = {m["name"] for m in harness.cell_metrics(bench, workload, bool(trace))}
    # the device-trace readers find no device on the CPU and say nothing
    assert set(res["metrics"]) <= want
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert "breakdown" in res
    else:  # the CPU has no device memory to read
        assert want - set(res["metrics"]) <= {"peak_gb"}


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = run_cmd("--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and perfbench/ alone prints nothing."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "0.2", "--device", "cpu", "--toy"],
                       capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


class _Slow:
    """A cell whose unit takes ``dt`` seconds."""

    def __init__(self, dt):
        self.dt = dt

    def unit(self):
        time.sleep(self.dt)
        return 3


def test_window_counts_the_unit_in_flight():
    cell = _Slow(0.3)
    run = harness.Run(cell, 0.5)
    harness.measure(cell, run, CPU)
    # 0.3 s ends before 0.5 s, so the second unit, in flight at 0.5 s, ends
    # the window at 0.6 s and counts
    assert run.units == 2 and run.work == 6
    assert run.window_s >= 0.6
    assert harness.reader("solve_s")(run) == pytest.approx(run.window_s / 6)
    assert harness.reader("scenes_per_s")(run) == pytest.approx(6 / run.window_s)


def test_roofline_work_by_hand():
    k1 = harness.reader("k1_roofline_pct.streamed").__globals__
    # Y (4, 3): the lower triangle of Y^T Y has 6 entries of 4 multiply-adds
    assert k1["syrk_flops"](4, 3) == 6 * 4 * 2
    run = harness.Run(None, 1.0)
    run.spans = {"syrk_lower": [1.0, 1.0]}
    run.shapes = {"syrk_lower": [(49152, 4500), (49152, 4500)]}
    # 2 x 9.955e11 operations at 1.65e14 /s take 12.07 ms; measured 2 ms
    assert harness.reader("k1_roofline_pct.streamed")(run) == pytest.approx(
        100 * 2 * 49152 * 4500 * 4501 / 1.65e14 / 2e-3)
    mv = harness.reader("matvec_roofline_pct.sparse").__globals__
    # 2 observations, 1 point, 1 camera: 2 x (96 + 4 + 8) + 24 + 4 x 91 + 72
    assert mv["matvec_bytes"](2, 1, 1) == 2 * 108 + 24 + 364 + 72


def test_collect_keeps_the_window_apart_from_the_traced_unit():
    """The unit traced after the window must not add to the window's
    counts, shapes or spans."""
    from perfbench.kinds.base import CellBase

    cell = CellBase({}, {}, 1, CPU)
    cell.instrument(None)
    with cell.spans.span("syrk_lower"):
        cell.shapes.setdefault("syrk_lower", []).append((4, 3))
        cell.count("retries", 1)
    run = harness.Run(cell, 1.0)
    cell.collect(run)
    with cell.spans.span("syrk_lower"):
        cell.shapes["syrk_lower"].append((4, 3))
        cell.count("retries", 1)
    assert run.shapes == {"syrk_lower": [(4, 3)]}
    assert run.counts == {"retries": 1} and len(run.spans["syrk_lower"]) == 1


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "mvrecon_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mvrecon_tpu.fake", object())
    assert harness.forbidden_modules() == ["mvrecon_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = "\n".join([
        "import runpy, sys",
        f"sys.argv = ['run', '--workload', {CELLS[0]!r}, '--seed', '5', '--seconds', '0.1',"
        " '--device', 'cpu', '--toy']",
        "try:",
        "    runpy.run_path('perfbench/run.py', run_name='__main__')",
        "except SystemExit as e:",
        "    assert not e.code, e.code",
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'mvrecon_tpu'}))"])
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_reference_derivatives_match_autograd():
    sc = scenes.batched_scenes(scenes.generator(7, "cpu"), 2, 6, 2, 0.005)
    B, F, P = 2, 6, sc.X.shape[0]
    xy = sc.x.transpose(1, 2).double()
    pb = ba.Problem(B, F, P, F, lambda dt: iter([ba.Chunk(0, P, xy.to(dt), None)]))
    g = torch.Generator().manual_seed(0)
    cams = ba.Cams(sc.f.double() + 0.01, 0.01 * torch.randn(B, F, 2, generator=g,
                                                               dtype=torch.float64),
                   sc.R.double(), sc.t.double())
    X = sc.X.double()[None].expand(B, -1, -1).clone()
    ch = next(pb.chunks(torch.float64))
    _, jc, jp = ba.terms(pb, cams, X, ch, ba.F64, True)

    def res(dc, dx):
        return ba.terms(pb, ba._apply(cams, dc), X + dx, ch, ba.F64, False)[0]

    jc_ad, jp_ad = torch.autograd.functional.jacobian(
        res, (torch.zeros(B, F, 9, dtype=torch.float64), torch.zeros(B, P, 3, dtype=torch.float64)))
    for b, p, f in ((0, 3, 2), (1, 30, 5)):
        torch.testing.assert_close(jc_ad[b, p, f, :, b, f], jc[b, p, f], rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(jp_ad[b, p, f, :, b, p], jp[b, p, f], rtol=1e-10, atol=1e-12)


def test_reference_windowed_step_equals_the_dense_one():
    sc = scenes.batched_scenes(scenes.generator(8, "cpu"), 1, 5, 2, 0.005)
    F, P = 5, sc.X.shape[0]
    xy = sc.x.transpose(1, 2).double()
    dense = ba.Problem(1, F, P, F, lambda dt: iter([ba.Chunk(0, P, xy.to(dt), None)]))
    # one more camera that no point sees: the windowed layout, window F
    lo = torch.zeros(1, P, dtype=torch.long)
    win = ba.Problem(1, F + 1, P, F, lambda dt: iter([ba.Chunk(0, P, xy.to(dt), lo)]))
    g = torch.Generator().manual_seed(1)
    X = sc.X.double()[None] + 0.01 * torch.randn(1, P, 3, generator=g, dtype=torch.float64)
    cams = ba.Cams(sc.f.double(), torch.zeros(1, F, 2, dtype=torch.float64), sc.R.double(),
                   sc.t.double())
    more = ba.Cams(*(torch.cat([a, a[:, :1]], 1) for a in cams))
    lam = torch.full((1,), 1e-3, dtype=torch.float64)
    a, b = ba.lm_step(dense, cams, X, lam, ba.F64), ba.lm_step(win, more, X, lam, ba.F64)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=1e-9)
    torch.testing.assert_close(a[3], b[3], rtol=1e-9, atol=0)


def test_round_tf32_keeps_ten_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -1.0 - 3 * 2**-12])
    assert ba.round_tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-10, -1.0 - 2**-10]


def cell_of(workload: str, seed: int):
    _, cfg, traffic, _ = harness.cell_spec(workload)
    traffic = harness.scaled(traffic, True)
    return harness.kind_module(traffic).Cell(cfg, traffic, seed, CPU)


def judge_window(cell, seed: int, units: int = 2) -> dict:
    for _ in range(units):
        cell.unit()
    return cell.judge(random.Random(seed))


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


@pytest.mark.parametrize("workload", CELLS)
def test_sound_runs_pass(workload):
    for seed in (101, 2**31 + 7):
        checks = judge_window(cell_of(workload, seed), seed)
        assert passes(checks), checks


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload):
    """The reference in the program's place with TF32 products."""
    for seed in (201, 202, 203):
        cell = cell_of(workload, seed)
        rng = random.Random(seed)
        if hasattr(cell, "sample"):
            idx = cell.sample(rng)
            checks = cell.judge_scenes(idx, cell.control_answer(idx))
        else:
            checks = cell.judge(rng, cell.control_answer())
        assert not passes(checks), checks


def _faulty(monkeypatch, workload: str, fault: str):
    """Break the entry the cell's window drives, underneath the harness."""
    if workload == "tube-batch1024":
        import mvrecon_tpu_torch.parallel.batched as mod

        name = "batched_euclidean_reconstruction"
    elif workload == "bal-sparse-1m":
        import mvrecon_tpu_torch.models.bundle_adjustment_sparse as mod

        name = "bundle_adjust_sparse"
    else:
        import mvrecon_tpu_torch.models.bundle_adjustment_streamed as mod

        name = "bundle_adjust_streamed"
    real = getattr(mod, name)

    def broken(*args, **kw):
        args = list(args)
        if fault == "unchanged":  # the solve hands back its start
            kw["config"] = dataclasses.replace(kw["config"], max_iter=0)
        if fault == "half":  # half of the work left out
            if workload == "tube-batch1024":
                x = args[0]
                half = real(x[: x.shape[0] // 2], *args[1:], **kw)
                return type(half)(*(v.repeat_interleave(2, 0)[: x.shape[0]]
                                    if torch.is_tensor(v) and v.dim() else v for v in half))
            if workload == "bal-sparse-1m":
                obs = args[0]
                w = obs.weights.clone()
                w[w.shape[0] // 2:] = 0.0
                args[0] = obs._replace(weights=w)
            else:
                vis = torch.ones(args[0].shape[:2]).numpy()
                vis[vis.shape[0] // 2:] = 0.0
                kw["visibility"] = vis
        res = real(*args, **kw)
        if fault == "altered":  # one camera moved where the answer is made
            t = res.t.clone()
            t[..., 1, :] += 0.01
            res = res._replace(t=t)
        return res

    monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, workload, fault):
    """The rest of a run, with the timed path broken underneath (one chip:
    no exchange between chips to leave out)."""
    _faulty(monkeypatch, workload, fault)
    res, _ = harness.execute(workload, 301, 0.1, False, "cpu", toy=True)
    assert res["correct"] is False, res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    """One short run of the cell at its own size on the card."""
    res, _ = harness.execute(workload, 401, 1.0, False, "cuda")
    assert res["correct"] is True, res["checks"]
