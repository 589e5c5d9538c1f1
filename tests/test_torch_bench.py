"""bench_gpu.py (the port's twin of bench.py), scripts/ladder_torch.py and
scripts/epoch_time_torch.py on the CPU at a tiny size: BENCH_DEVICE=cpu
runs the kernels' plain versions and measures no speed.

bench_gpu.py runs as a subprocess, as tests/test_bench_retry.py runs
bench.py: its one JSON line and keys, a metric name that follows BENCH_HW
and BENCH_RESIZE, the bounded retry of the device claim, a non-zero exit
with no JSON line for a failed measurement and for a missing card, the JAX
route names (xla is cuDNN, conv_impl='torch'), the split ensemble over two
CPU ranks. In process: the model against bench.py's (the config fields of
JAX's canonical_config with bench.py:162-177's overrides; one float32
forward at drop_prob=None on JAX's weights within the 1e-5 of
tests/test_torch_unet.py), and a measurement's statistics equal to the
eager route's from the same seed (the CPU runs the same chunk step either
way). Then the ladder's rungs and its exit on a failed rung, and the epoch
arms on a tiny split tree."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import unet_research_tpu.models.unet as junet
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import bench_gpu  # noqa: E402
import ladder_torch  # noqa: E402

TINY = {"filters": 4, "model_depth": 2, "group_norm_groups": 2}
TINY_ENV = {
    "BENCH_DEVICE": "cpu",
    "BENCH_RETRY_SLEEP": "0",
    "BENCH_ITERS": "4",
    "BENCH_CHUNK": "2",
    "BENCH_HW": "48x40",
    "BENCH_FILTERS": "4",
    "BENCH_DEPTH": "2",
    "BENCH_GROUPS": "2",
    "OMP_NUM_THREADS": "2",
}
KEYS = {"metric", "value", "unit", "vs_baseline", "pipeline", "card", "times", "warmup_s",
        "device"}
SMALL_FLAGS = ["-device", "cpu", "-filters", "4", "-model_depth", "2", "-group_norm_groups", "2"]


def _run(args, extra_env=None, drop=()):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "UNET_CONV_IMPL", "UNET_DB_IMPL", "EPOCH_DATA"))}
    env.update({**TINY_ENV, **(extra_env or {})})
    for key in drop:
        env.pop(key, None)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def _json_lines(out):
    return [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("extra,metric", [
    ({}, "mc_dropblock_passes_per_sec_48x40_1chip"),
    ({"BENCH_RESIZE": "32"}, "mc_dropblock_passes_per_sec_resize32_1chip"),
], ids=["native", "resize"])
def test_bench_prints_one_json_line(extra, metric):
    out = _run(["bench_gpu.py"], extra)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = _json_lines(out)
    assert len(lines) == 1
    rec = lines[0]
    assert KEYS <= set(rec)
    assert rec["metric"] == metric
    assert rec["unit"] == "passes/sec"
    assert rec["pipeline"] == "pair+fused"
    assert rec["card"] is None  # no card on the CPU
    assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert len(rec["times"]) == 3 and len(rec["warmup_s"]) == 2
    assert rec["value"] == round(4 / min(rec["times"]), 2) > 0
    assert rec["vs_baseline"] == round(4 / min(rec["times"]) / 1000.0, 4)
    assert rec["launches_per_predict"] == [{}, {}, {}]  # plain versions: no kernel launched


def test_bench_survives_transient_init_failure():
    out = _run(["bench_gpu.py"], {"BENCH_SIM_INIT_FAIL": "1", "BENCH_ATTEMPTS": "3"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "attempt 1/3" in out.stderr
    assert len(_json_lines(out)) == 1


def test_bench_gives_up_after_bounded_attempts():
    out = _run(["bench_gpu.py"], {"BENCH_SIM_INIT_FAIL": "5", "BENCH_ATTEMPTS": "2"})
    assert out.returncode != 0
    assert "attempt 2/2" in out.stderr
    assert _json_lines(out) == []


def test_bench_measure_failure_exits_without_a_line():
    """No fallback pipeline: a failed measurement ends the run."""
    out = _run(["bench_gpu.py"], {"BENCH_SIM_MEASURE_FAIL": "1"})
    assert out.returncode != 0
    assert "simulated measurement failure" in out.stderr
    assert _json_lines(out) == []


def test_bench_without_a_card_names_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: bench_gpu.py measures on it")
    out = _run(["bench_gpu.py"], drop=("BENCH_DEVICE",))
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert _json_lines(out) == []


def test_bench_xla_maps_to_cudnn():
    out = _run(["bench_gpu.py"], {"UNET_CONV_IMPL": "xla", "UNET_DB_IMPL": "elementwise"})
    assert out.returncode == 0, out.stderr[-2000:]
    (rec,) = _json_lines(out)
    assert rec["pipeline"] == "xla(torch)+elementwise"
    assert bench_gpu.model_config("xla", "elementwise", TINY).conv_impl == "torch"
    assert bench_gpu.model_config("pair", "fused", TINY).conv_impl == "pair"


@pytest.mark.parametrize("env", [{"UNET_CONV_IMPL": "mosaic"}, {"UNET_DB_IMPL": "pallas"},
                                 {"UNET_CONV_IMPL": "torch"}])
def test_bench_rejects_unknown_routes(env):
    with pytest.raises(ValueError, match="UNET_"):
        bench_gpu.pipeline_from_env(env)


def test_bench_devices_split_over_cpu_ranks():
    out = _run(["bench_gpu.py"], {"BENCH_DEVICES": "2", "BENCH_CHUNK": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    (rec,) = _json_lines(out)
    assert rec["metric"] == "mc_dropblock_passes_per_sec_48x40_2chip"
    assert rec["device"]["count"] == 2
    assert rec["value"] > 0


def test_workload_from_env():
    work = bench_gpu.Workload.from_env({})
    assert (work.iters, work.hw, work.resize, work.chunk, work.tiny, work.devices,
            work.device) == (1000, (584, 565), 0, 16, {}, 1, "cuda")
    assert work.metric() == "mc_dropblock_passes_per_sec_584x565_1chip"
    r256 = bench_gpu.Workload.from_env({"BENCH_RESIZE": "256"})
    assert (r256.chunk, r256.metric()) == (128, "mc_dropblock_passes_per_sec_resize256_1chip")
    with pytest.raises(ValueError, match="BENCH_DEVICE"):
        bench_gpu.Workload.from_env({"BENCH_DEVICE": "tpu"})


def _jax_bench_config(conv, mask, dtype):
    """bench.py's model (bench.py:162-177) under the tiny knobs."""
    cfg = junet.canonical_config(dtype=dtype, **TINY)
    return junet.UNetConfig(**{
        **cfg.__dict__,
        "dropblock": junet.DropBlockConfig(kind="dependent", block_size=7, drop_prob=0.15,
                                           use_scheduler=False, mask_impl=mask),
        "conv_impl": conv,
    })


ROUTES = [("pair", "fused"), ("xla", "elementwise"), ("pair", "kernel")]


@pytest.mark.parametrize("conv,mask", ROUTES, ids=lambda v: v)
def test_model_config_matches_bench_py(conv, mask):
    ours = dataclasses.asdict(bench_gpu.model_config(conv, mask, TINY))
    theirs = dataclasses.asdict(_jax_bench_config(conv, mask, jnp.bfloat16))
    assert set(ours) == set(theirs)
    assert ours.pop("dtype") == torch.bfloat16 and theirs.pop("dtype") == jnp.bfloat16
    assert ours.pop("conv_impl") == bench_gpu.CONV_IMPLS[theirs.pop("conv_impl")]
    assert ours == theirs


@pytest.mark.parametrize("conv,mask", ROUTES[:2], ids=lambda v: v)
def test_forward_matches_jax(conv, mask):
    im, _, _ = bench_gpu.bench_input((48, 40))
    jcfg = _jax_bench_config(conv, mask, jnp.float32)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(0), jnp.asarray(im))
    ref = np.asarray(junet.UNet(jcfg).apply(variables, jnp.asarray(im)))
    model = bench_gpu.build_model(conv, mask, TINY, "cpu", dtype=torch.float32)
    model.load_state_dict(jax_params_to_state_dict(variables, jcfg))
    with torch.no_grad():
        ours = model(torch.from_numpy(im)).numpy()
    assert ours.shape == ref.shape == (1, 48, 40, 1)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_measure_matches_the_eager_route():
    """The measured engine runs its body chunks as the device program (on
    the CPU the same step, eagerly): the last timed call's statistics equal
    those of every chunk run from the host, from its seed."""
    work = bench_gpu.Workload(iters=9, hw=(48, 40), chunk=2, tiny=TINY, device="cpu")
    model = bench_gpu.build_model("pair", "fused", TINY, "cpu")
    out = bench_gpu.measure(bench_gpu.make_engine(model, work, "cpu"), work)
    assert len(out["times"]) == 3 and len(set(out["seeds"])) == 3
    assert out["programs"] == 1 and out["program_reused"]
    assert out["passes_per_s"] == 9 / min(out["times"])
    eager = bench_gpu.make_engine(model, work, "cpu", program=False)
    im, gt, mask = bench_gpu.bench_input(work.hw)
    mean, std, *_ = eager.predict(im, gt, mask, bench_gpu.DROP_PROB,
                                  generator=torch.Generator().manual_seed(out["seeds"][-1]))
    torch.testing.assert_close(out["mean"], mean, rtol=0, atol=1e-6)
    torch.testing.assert_close(out["std"], std, rtol=0, atol=1e-6)
    assert float(out["std"].max()) > 0


def test_ladder_selection():
    assert [r[0] for r in ladder_torch.select("native/pair")] == ["native/pair"]
    assert len(ladder_torch.select("native")) == 7
    assert len(ladder_torch.select("r256")) == 7
    assert len(ladder_torch.select("")) == len(ladder_torch.RUNGS) == 21
    assert ladder_torch.select("no-such-rung") == []
    assert ladder_torch.main(["no-such-rung"]) == 2


def test_ladder_runs_one_rung():
    out = _run(["scripts/ladder_torch.py", "native/pair"])
    assert out.returncode == 0, out.stderr[-2000:]
    (row,) = _json_lines(out)
    assert row["rung"] == "native/pair" and row["pipeline"] == "pair+elementwise"
    assert row["passes_per_sec"] > 0 and len(row["times"]) == 3 and row["compile_s"] > 0
    assert "== ladder summary ==" in out.stdout


def test_ladder_exits_nonzero_on_a_failed_rung():
    """The first of two rungs fails: its error line, the second rung's
    result, then a non-zero exit."""
    out = _run(["scripts/ladder_torch.py", "native/pair+"], {"BENCH_SIM_MEASURE_FAIL": "1"})
    assert out.returncode == 1
    failed, done = _json_lines(out)
    assert failed["rung"] == "native/pair+fused" and "simulated" in failed["error"]
    assert done["rung"] == "native/pair+fused,c32" and done["passes_per_sec"] > 0


@pytest.fixture(scope="module")
def split_tree(tmp_path_factory):
    """A tiny augmented tree (tests/test_torch_cli.py's aug_data layout)."""
    root = tmp_path_factory.mktemp("aug")
    rng = np.random.default_rng(0)
    for split, n, with_targets in [("train", 3, True), ("val", 1, True), ("test", 1, False)]:
        d = root / split
        (d / "images").mkdir(parents=True)
        (d / "masks").mkdir()
        if with_targets:
            (d / "targets").mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (32, 32)).astype(np.uint8)).save(
                d / "images" / f"{i}_image.png")
            Image.fromarray(np.full((32, 32), 255, np.uint8)).save(d / "masks" / f"{i}_mask.png")
            if with_targets:
                Image.fromarray(((rng.random((32, 32)) > 0.5) * 255).astype(np.uint8)).save(
                    d / "targets" / f"{i}_target.png")
    return str(root)


def test_epoch_time_runs_both_arms(split_tree):
    out = _run(["scripts/epoch_time_torch.py", "1", *SMALL_FLAGS], {"EPOCH_DATA": split_tree})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[epoch_time] arm=xla total=" in out.stdout
    assert "[epoch_time] arm=pair total=" in out.stdout
    rows = _json_lines(out)
    assert [r["arm"] for r in rows] == ["xla", "pair"]
    for row in rows:
        assert row["epochs"] == 1 and len(row["epoch_s"]) == 1
        assert row["s_per_epoch_after_first"] is None
        assert np.isfinite(row["final_train_loss"]) and row["total_s"] > row["epoch_s"][0] > 0
        assert row["card"] is None and row["launches"] == {}


@pytest.mark.parametrize("data", [None, "no/such/tree"], ids=["unset", "missing"])
def test_epoch_time_needs_epoch_data(data):
    out = _run(["scripts/epoch_time_torch.py", "1", *SMALL_FLAGS],
               {} if data is None else {"EPOCH_DATA": data})
    assert out.returncode != 0
    assert "EPOCH_DATA" in out.stderr
    assert _json_lines(out) == []
