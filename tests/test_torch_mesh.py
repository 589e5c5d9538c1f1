"""The port's data-parallel slice (unet_research_tpu_torch/parallel/) against
the JAX package under its mesh: the twin of tests/test_mesh.py.

Two gloo CPU ranks (subprocesses on a free 127.0.0.1 port, started once for
the module) run the port's data-parallel train step and its split
MC-DropBlock engine; the JAX package computes the same global batch in one
process (its sharded step equals its one-device step: tests/test_mesh.py).
Weights come across with utils/convert.py, site keys from the JAX step's
folded key (a spy on an unjitted run). The model is small (filters 4-8,
depth 2).

Tolerances: the hash and the plain K1/K2 at a sample offset bit-equal to
the full batch's rows; the step's loss rel 2e-5 and parameters rtol 2e-4 /
atol 2e-6 (tests/test_mesh.py:60-63), BatchNorm's running means 1e-5 and
its running variances 1e-4 after torch's unbiased factor at the global
count; the two ranks' parameters bit-identical; the MC engine's mean rtol
1e-5 and std rtol 1e-4 (test_mc_engine_sharded_chunk_sweep).
"""

import dataclasses
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import unet_research_tpu.models.unet as junet
from unet_research_tpu.parallel import make_mesh as jmake_mesh
from unet_research_tpu.train import POLICIES as JPOLICIES
from unet_research_tpu.train import Trainer as JTrainer
from unet_research_tpu.train import TrainerConfig as JTrainerConfig
from unet_research_tpu.uncertainty import MCDropBlockEngine as JMCDropBlockEngine
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops import dropblock as tdb
from unet_research_tpu_torch.ops.cuda import dropblock_kernel as dbk
from unet_research_tpu_torch.parallel import Mesh, make_mesh, multihost_initialize, shard_rows
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

REPO = pathlib.Path(__file__).resolve().parents[1]
RANKS = 2
LR = 0.05


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(worker: str, job: pathlib.Path, timeout: float = 240) -> list:
    """Run `worker` (Python source taking rank, world, port, job path and
    output path) in RANKS processes; returns each rank's torch.load-ed
    output."""
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    outs = [job.with_suffix(f".rank{r}") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, "-c", worker, str(r), str(RANKS), str(port),
                               str(job), str(outs[r])], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


# --- the mesh -----------------------------------------------------------------

@pytest.fixture
def one_rank_group():
    multihost_initialize(f"tcp://127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    yield
    dist.destroy_process_group()


def test_mesh_axes(one_rank_group):
    """The twin of test_mesh_axes: axes and shape of a mesh over the group,
    ValueError for more ranks than the group has, the reserved 'model' axis,
    and shard_rows' contiguous blocks."""
    mesh = make_mesh(device="cpu")
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1 and mesh.rank == 0
    assert make_mesh(data=1, device="cpu").shape["data"] == 1
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh(data=2, device="cpu")
    with pytest.raises(NotImplementedError):
        make_mesh(data=1, model=2, device="cpu")
    two = Mesh(None, 2, 1, 1, torch.device("cpu"))
    assert shard_rows(4, two) == (2, 4)
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(3, two)


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="multihost_initialize"):
        make_mesh(device="cpu")


def test_mc_engine_rejects_indivisible_chunk():
    model = tunet.UNet(tunet.canonical_config(filters=4, model_depth=2, group_norm_groups=2),
                       device="cpu")
    mesh = Mesh(None, 2, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        MCDropBlockEngine(model, num_iterations=16, chunk=3, device="cpu", mesh=mesh)


# --- the hash and the plain K1/K2 at a sample offset --------------------------

def _key(seed):
    return tunet.draw_site_keys(1, torch.Generator().manual_seed(seed))[0]


@pytest.mark.parametrize("block_size,kind", [(3, "dependent"), (5, "independent"),
                                             (4, "dependent"), (7, "dependent")])
def test_masks_at_an_offset_equal_the_full_batch_rows(block_size, kind):
    """Rows [k, k+n) of the 6-sample draw equal the n-sample draw at
    sample_offset k, bit for bit: the counter hash, the mask (odd and even
    b) and, for odd b, K2's and K1's plain versions with their keep counts."""
    shape, key = (6, 13, 11, 5), _key(block_size)
    gamma_fn = (tdb.dropblock_gamma_dependent if kind == "dependent"
                else tdb.dropblock_gamma_independent)
    gamma = gamma_fn(13, 11, block_size, 0.3)
    full_u = tdb.hash_uniform(key, shape)
    full = tdb._dropped(shape, key, gamma, block_size, 0)
    assert 0 < int(full.sum()) < full.numel()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    ab = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 6, 5)).astype(np.float32))
    odd = block_size % 2 == 1
    if odd:
        mask, keep = dbk.dropblock_mask(shape, key, gamma, block_size)
        out, keep1 = dbk.dropblock_fused_apply(x, ab, key, gamma, block_size)
    for k, n in ((0, 2), (2, 2), (3, 3), (5, 1)):
        part = (n,) + shape[1:]
        assert torch.equal(tdb.hash_uniform(key, part, k), full_u[k:k + n])
        assert torch.equal(tdb._dropped(part, key, gamma, block_size, k), full[k:k + n])
        if odd:
            m, kp = dbk.dropblock_mask(part, key, gamma, block_size, sample_offset=k)
            assert torch.equal(m, mask[k:k + n]) and torch.equal(kp, keep[k:k + n])
            o, kp1 = dbk.dropblock_fused_apply(x[k:k + n].contiguous(),
                                               ab[:, k:k + n].contiguous(), key, gamma,
                                               block_size, sample_offset=k)
            assert torch.equal(o, out[k:k + n]) and torch.equal(kp1, keep1[k:k + n])
    with pytest.raises(ValueError, match="uint32"):
        tdb.hash_uniform(key, (2, 2**16, 2**15, 1), sample_offset=1)


# --- the data-parallel step against JAX -----------------------------------------

SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)
DB_DEP = dict(kind="dependent", block_size=3, use_scheduler=True, start_drop_prob=0.0,
              max_drop_prob=0.2, nr_steps=5)
DB_IND = {**DB_DEP, "kind": "independent"}
# name: (model overrides, DropBlock, policy, size plan entry, masks differ by row)
STEP_CASES = {
    "group_fold": ({}, DB_DEP, "none", -1, False),
    "batch_norm": ({"norm": "batch", "remat": True}, DB_DEP, "none", -1, False),
    "dropblock_off": ({}, {"kind": None}, "none", -1, False),
    "uni": ({}, DB_IND, "uni", 16, False),
    "fov_differs": ({"fold_rescale": False}, DB_DEP, "none", -1, True),
}


def _global_batch(rng, masks_differ: bool, h=20, w=24):
    im = rng.random((4, h, w, 1), dtype=np.float32)
    gt = (rng.random((4, h, w, 1)) > 0.7).astype(np.float32)
    mask = np.ones((4, h, w, 1), np.float32)
    mask[:, :3] = 0.0
    mask[:, :, -2:] = 0.0
    if masks_differ:  # rank 0's rows see a much smaller FOV than rank 1's
        mask[:2, :, : w // 2] = 0.0
    return im, gt, mask


def _spy_site_keys(monkeypatch):
    calls = []
    for name in ("dropblock_dependent", "dropblock_independent"):
        real = getattr(junet, name)

        def spy(x_, key, *a, _real=real, **k):
            calls.append(np.asarray(jax.random.key_data(key)).reshape(-1).astype(np.int64))
            return _real(x_, key, *a, **k)

        monkeypatch.setattr(junet, name, spy)
    return calls


def _site_keys(model, variables, key, monkeypatch) -> torch.Tensor:
    """The (S, 2) key words a JAX forward keyed `key` hands its mask sites,
    from an unjitted forward on a tiny input (the keys do not depend on it)."""
    with monkeypatch.context() as m:
        calls = _spy_site_keys(m)
        with jax.disable_jit():
            model.apply(variables, jnp.zeros((1, 16, 16, 1)), drop_prob=0.1,
                        rngs={"dropblock": key})
    return torch.from_numpy(np.stack(calls))


def _jax_step(name, monkeypatch):
    """JAX's one-process step on the global batch of 4 at step 3 of the
    DropBlock ramp, and the port's job for the case: the same weights, batch
    and site keys (those of the step's folded key, fold_in(key, step))."""
    over, db, policy, size, differ = STEP_CASES[name]
    jdb = junet.DropBlockConfig(**db, **({"mask_impl": None} if db["kind"] else {}))
    jcfg = junet.canonical_config(dropblock=jdb, **SMALL, **over)
    model = junet.UNet(jcfg)
    jt = JTrainer(model, JPOLICIES[policy],
                  JTrainerConfig(lr=LR, momentum=0.99, auto_lr_find=False, verbose=False))
    variables = jt.init_params(seed=0)
    jstate = jt.create_state(variables, LR).replace(step=jnp.asarray(3, jnp.int32))
    batch = _global_batch(np.random.default_rng(7), differ)
    key = jax.random.PRNGKey(0)
    keys = None
    if db["kind"]:
        keys = _site_keys(junet.UNet(dataclasses.replace(jcfg, remat=False)),
                          junet.as_variables(variables), jax.random.fold_in(key, 3), monkeypatch)
    jstate, loss = jt._train_step(jstate, *(jnp.asarray(a) for a in batch), LR, key, size)
    job = {"cfg": {**SMALL, **over}, "db": db, "policy": policy, "size": size,
           "batch": batch, "keys": keys,
           "state_dict": jax_params_to_state_dict(variables, jcfg)}
    ref = jax_params_to_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats},
                                   jcfg)
    return job, (float(loss), ref)


_WORKER = r"""
import sys

import torch

rank, world, port, job_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
from unet_research_tpu_torch.data.loading import shard_batch
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.parallel.mesh import make_mesh, multihost_initialize
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine, mc_dropblock

multihost_initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
mesh = make_mesh(device="cpu")
jobs = torch.load(job_path, weights_only=False)
out = {"steps": {}, "mc": {}}
for name, job in jobs["steps"].items():
    cfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(**job["db"]), **job["cfg"])
    model = tunet.UNet(cfg, device="cpu")
    tcfg = TrainerConfig(lr=0.05, momentum=0.99, auto_lr_find=False, train_batch=4,
                         verbose=False)
    trainer = Trainer(model, POLICIES[job["policy"]], tcfg, mesh=mesh, device="cpu")
    # rank 1 starts from other weights: create_state hands it rank 0's
    sd = {k: v if rank == 0 else v + 1.0 for k, v in job["state_dict"].items()}
    state = trainer.create_state(sd, 0.05)
    state.step = 3
    rows = shard_batch(tuple(torch.from_numpy(a) for a in job["batch"]), mesh)
    loss = trainer.train_step(state, *rows, 0.05, job["size"], site_keys=job["keys"])
    out["steps"][name] = {"loss": float(loss), "state_dict": model.state_dict()}
for chunk, job in jobs["mc"].items():
    cfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(**job["db"]), **job["cfg"])
    model = tunet.UNet(cfg, device="cpu")
    model.load_state_dict(job["state_dict"])
    keys = iter(job["keys"])
    mc_dropblock.draw_site_keys = lambda n, generator: next(keys)
    engine = MCDropBlockEngine(model, num_iterations=2 * chunk, return_num=0, chunk=chunk,
                               device="cpu", mesh=mesh)
    mean, std, *_ = engine.predict(job["im"], job["im"], job["ones"], 0.15)
    out["mc"][chunk] = {"mean": mean, "std": std}
torch.save(out, out_path)
"""

# chunk: fold_rescale (off: the fused sites' whole-batch rescale over the chunk)
MC_CHUNKS = {8: True, 32: False}


def _jax_mc(chunk, monkeypatch):
    """The JAX engine under its 8-device mesh, and the per-chunk site keys of
    the same key: chunk i runs on fold_in(key, i) (uncertainty/ensemble.py),
    whatever the mesh."""
    db = dict(kind="independent", block_size=3, use_scheduler=False)
    small = dict(filters=4, model_depth=2, group_norm_groups=2, fold_rescale=MC_CHUNKS[chunk])
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(**db), **small)
    model = junet.UNet(jcfg)
    im = np.random.default_rng(1).random((1, 24, 24, 1), dtype=np.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(im))["params"]
    ones = np.ones_like(im)
    key = jax.random.PRNGKey(5)
    sharded = JMCDropBlockEngine(model, num_iterations=2 * chunk, return_num=0, chunk=chunk,
                                 mesh=jmake_mesh(data=8))
    mean, std, *_ = sharded.predict(params, im, im, ones, key, 0.15)
    keys = [_site_keys(model, {"params": params}, jax.random.fold_in(key, i), monkeypatch)
            for i in range(2)]
    job = {"cfg": small, "db": db, "im": im, "ones": ones, "keys": keys,
           "state_dict": jax_params_to_state_dict(params, jcfg)}
    return job, (np.asarray(mean), np.asarray(std))


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """JAX's references and the two ranks' results of every case (one pair of
    rank processes for the module)."""
    mp = pytest.MonkeyPatch()
    try:
        steps = {name: _jax_step(name, mp) for name in STEP_CASES}
        mc = {chunk: _jax_mc(chunk, mp) for chunk in MC_CHUNKS}
    finally:
        mp.undo()
    job = tmp_path_factory.mktemp("dp") / "job.pt"
    torch.save({"steps": {n: j for n, (j, _) in steps.items()},
                "mc": {c: j for c, (j, _) in mc.items()}}, job)
    ranks = run_ranks(_WORKER, job)
    return steps, mc, ranks


def _bn_count(key: str, depth: int, h=20, w=24) -> int:
    """Global positions per channel of a BatchNorm site of the port (batch 4)."""
    parts = key.split(".")
    if parts[0] == "conn_block":
        lvl = depth
    elif parts[0] == "down_blocks":
        lvl = int(parts[1]) + int(parts[2])  # the pool norm runs one level down
    else:
        lvl = depth - 1 - int(parts[1])
    return 4 * (h >> lvl) * (w >> lvl)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_dp_step_matches_jax(dp_runs, name):
    """Two ranks, two rows each, against JAX's step on the global batch of 4:
    GroupNorm with fold_rescale, BatchNorm under remat (global batch
    statistics, also in the re-run; the whole-batch rescale), DropBlock off, a `uni` size-plan step at 16, and
    FOV masks that differ between the ranks' rows (the global loss
    normaliser; GroupNorm without fold). The ranks end bit-identical
    (rank 1 started from other weights)."""
    steps, _, ranks = dp_runs
    (jloss, ref), got = steps[name][1], [r["steps"][name] for r in ranks]
    assert got[0]["loss"] == got[1]["loss"]
    for k in ref:
        assert torch.equal(got[0]["state_dict"][k], got[1]["state_dict"][k]), k
    assert got[0]["loss"] == pytest.approx(jloss, rel=2e-5)
    sd = got[0]["state_dict"]
    checked = 0
    for k, v in ref.items():
        if k.endswith("running_mean"):
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-5, err_msg=k)
        elif k.endswith("running_var"):
            n = _bn_count(k, SMALL["model_depth"])
            unbiased, biased = (sd[k].numpy() - 0.9) / 0.1, (v.numpy() - 0.9) / 0.1
            np.testing.assert_allclose(unbiased * (n - 1) / n, biased, atol=2e-5, rtol=1e-4,
                                       err_msg=k)
            checked += 1
        elif "num_batches" not in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=2e-6, rtol=2e-4,
                                       err_msg=f"parameter {k}")
    assert checked == (14 if name == "batch_norm" else 0)


@pytest.mark.parametrize("chunk", list(MC_CHUNKS))
def test_mc_engine_split_matches_jax_mesh(dp_runs, chunk):
    """The split engine on two ranks (chunk/2 members each, at sample
    offsets 0 and chunk/2, K1's plain version at every site) against JAX's
    engine sharded over 8 devices on the same per-chunk keys, with
    fold_rescale at chunk 8 and the whole-chunk rescale at chunk 32; both
    ranks hold the same statistics."""
    _, mc, ranks = dp_runs
    mean, std = mc[chunk][1]
    got = [r["mc"][chunk] for r in ranks]
    assert torch.equal(got[0]["mean"], got[1]["mean"]) and torch.equal(got[0]["std"], got[1]["std"])
    np.testing.assert_allclose(got[0]["mean"].numpy(), mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0]["std"].numpy(), std, rtol=1e-4, atol=1e-6)
    assert float(got[0]["std"].max()) > 0.01  # the members' masks differ
