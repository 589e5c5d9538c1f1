"""The port's programs under a mesh: the trainer's step program (a fit's
stepped epochs and lr_find's sweep), its forward program and the MC
engine's body-chunk program over the ranks of a process group, the twins
of the JAX package's jitted mesh programs (unet_research_tpu/train/
loop.py:173-189, uncertainty/mc_dropblock.py:51-89).

Two gloo CPU ranks (subprocesses on a free 127.0.0.1 port, started once for
the module, as tests/test_torch_multihost.py starts them) run:

(a) a data-parallel fit of 2 epochs of 6 items at train_batch 4 (batches
    of 4 and 2 rows: 2 and 1 per rank, the last partial) with DropBlock
    ramped, and an lr_find sweep of 14 steps, through the step program
    against program=False (every step from the host on batch_iterator's
    batches): losses, weights, momentum, key generator and suggestion
    bit-equal, and the program's per-rank tables equal to shard_batch's
    cut of the shared shuffled order;
(b) the same fit with DropBlock off against JAX's fit on its 2-device CPU
    mesh from the same weights and seed;
(c) the split MC engine through its program against its host route, and
    against JAX's engine on its 8-device mesh on the same per-chunk keys;
(d) a norm='batch' fit (BatchNorm psums its batch moments inside the
    step), program against host;
(f) the card's schedule with the graph stood in for (the capture forced
    on): every rank warms up, agrees on each key and captures it in the
    same order, and the replays give the host's numbers; ranks holding
    different keys all raise instead of waiting.

(e) tests the capture decision in one process: false on the CPU, and on a
card true without a mesh and under NCCL, false under gloo.

Tolerances: program against host exact (the same function on the same
inputs); against JAX the fit's losses rel 2e-5 + atol 2e-6 and its weights
rtol 2e-4 / atol 2e-6 (tests/test_torch_mesh.py::test_dp_step_matches_jax,
float32 steps of the same global batches), the MC engine's mean rtol 1e-5
and std rtol 1e-4 (test_mc_engine_split_matches_jax_mesh). The model is
small (filters 4-8, depth 2).
"""

import contextlib
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from unet_research_tpu_torch.data import ArrayDataset
from unet_research_tpu_torch.data.loading import shard_batch
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.parallel import Mesh, mesh as tmesh
from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig, lr_find
from unet_research_tpu_torch.train import loop as tloop
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

TESTS = pathlib.Path(__file__).resolve().parent

SMALL = dict(filters=8, model_depth=2, group_norm_groups=4)
RAMP = dict(kind="dependent", block_size=3, use_scheduler=True, start_drop_prob=0.0,
            max_drop_prob=0.2, nr_steps=4)
FIT = dict(max_epochs=2, lr=0.02, momentum=0.9, clip_norm=1.0, auto_lr_find=False, seed=7,
           verbose=False, train_batch=4, val_batch=2)
N_TRAIN, N_VAL = 6, 4
MC = dict(num_iterations=21, return_num=3, chunk=4)  # saved 3 whole, 4 body chunks, 2 split


def dataset(n: int, seed: int, h: int = 20, w: int = 24) -> ArrayDataset:
    """uint8 images, targets and FOV masks; the FOVs differ between rows."""
    rng = np.random.default_rng(seed)
    ims = rng.integers(0, 256, (n, h, w, 1), dtype=np.uint8)
    gts = ((rng.random((n, h, w, 1)) > 0.7) * 255).astype(np.uint8)
    masks = np.full((n, h, w, 1), 255, np.uint8)
    masks[: n // 2, :, :5] = 0
    return ArrayDataset(ims, gts, masks)


def model_cfg(db: dict, **over):
    return tunet.canonical_config(dropblock=tunet.DropBlockConfig(**db), **{**SMALL, **over})


def weights(cfg, seed: int = 0) -> dict:
    return tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(seed)).state_dict()


@contextlib.contextmanager
def recorded_programs():
    """Every step program made while active, with the tables of each fill:
    (this rank's table rows, each row's number of items)."""
    made, init, fill = [], tloop._StepProgram.__init__, tloop._StepProgram.fill

    def record(self, *args):
        init(self, *args)
        self.fills = []
        made.append(self)

    def record_fill(self, *args, **kwargs):
        fill(self, *args, **kwargs)
        self.fills.append((self.order.clone(), list(self.rows)))

    tloop._StepProgram.__init__, tloop._StepProgram.fill = record, record_fill
    try:
        yield made
    finally:
        tloop._StepProgram.__init__, tloop._StepProgram.fill = init, fill


def fit_run(mesh, cfg, sd, program: bool, root: str, tag: str, **over) -> dict:
    """A fit of FIT (with `over`) from `sd`; returns what the checks read."""
    trainer = Trainer(tunet.UNet(cfg, device="cpu"), POLICIES["none"],
                      TrainerConfig(**{**FIT, **over}), mesh=mesh, device="cpu",
                      program=program)
    with recorded_programs() as made:
        state, history, _ = trainer.fit(dataset(N_TRAIN, 1), dataset(N_VAL, 2),
                                        os.path.join(root, tag), params=sd)
    return {"history": history, "state_dict": trainer.model.state_dict(), "step": state.step,
            "momentum": [v.clone() for v in state.momentum_buffers()],
            "keys": trainer.key_generator.get_state(),
            "fills": [f for p in made for f in p.fills],
            "captures_steps": trainer.captures_steps,
            "captures_forwards": trainer.captures_forwards}


def expected_fills(mesh, seed: int, epochs: int) -> list:
    """Each epoch's rows of this rank, as batch_iterator feeds them: the
    shared order shuffled by the seed's generator, each global batch cut by
    shard_batch."""
    rng, out = np.random.default_rng(seed), []
    for _ in range(epochs):
        order = np.arange(N_TRAIN)
        rng.shuffle(order)
        out.append([shard_batch(order[s:s + FIT["train_batch"]], mesh).tolist()
                    for s in range(0, N_TRAIN, FIT["train_batch"])])
    return out


def lr_find_run(mesh, cfg, sd, program: bool) -> dict:
    model = tunet.UNet(cfg, device="cpu")
    model.load_state_dict(sd)
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(**{**FIT, "seed": 3}), mesh=mesh,
                      device="cpu")
    losses = []
    if program:
        with recorded_programs() as made:
            lr = lr_find(trainer, None, dataset(N_TRAIN, 1), None, 3, num_training=14)
        prog, = made
        losses = prog.losses[:int(prog.index)].tolist()
    else:
        step = trainer.train_step

        def spy(*args, **kwargs):
            loss = step(*args, **kwargs)
            losses.append(float(loss))
            return loss

        trainer.train_step = spy
        lr = lr_find(trainer, None, dataset(N_TRAIN, 1), None, 3, num_training=14,
                     program=False)
    return {"lr": lr, "losses": losses, "keys": trainer.key_generator.get_state(),
            "state_dict": trainer.model.state_dict()}


def mc_run(mesh, job: dict, program: bool, keys=None) -> tuple:
    """The split engine on `job`'s model and image, every chunk's site keys
    from `keys` (JAX's) when given, else from the engine's generator."""
    from unet_research_tpu_torch.uncertainty import mc_dropblock

    model = tunet.UNet(model_cfg(job["db"], **job["over"]), device="cpu")
    model.load_state_dict(job["state_dict"])
    draw = mc_dropblock.draw_site_keys
    if keys is not None:
        it = iter(keys)
        mc_dropblock.draw_site_keys = lambda n, generator: next(it)
    try:
        engine = MCDropBlockEngine(model, **job["mc"], device="cpu", mesh=mesh, program=program,
                                   generator=torch.Generator().manual_seed(5))
        out = engine.predict(job["im"], job["im"], job["ones"], 0.15)[:3]
    finally:
        mc_dropblock.draw_site_keys = draw
    return out, engine.program, engine.captures, len(engine.programs)


def card_schedule_run(mesh, cfg, sd, root: str) -> dict:
    """fit_run through the card's route with the capture forced on and the
    graph stood in for (tests/test_torch_eval_program.py::_card_schedule),
    each key's agreement recorded."""
    import test_torch_eval_program as te

    agreed, agree = [], tmesh.agree

    def spy(key, m):
        agreed.append(repr(key))
        return agree(key, m)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tmesh, "agree", spy)
        mp.setattr(launches, "captures_on_card", lambda program=True, mesh=None: program)
        with te._card_schedule(mp) as seen:
            run = fit_run(mesh, cfg, sd, True, root, "card", max_epochs=4)
            step_prog, = seen["step"]
            graphs = seen["captures"]
            run.update(graphs=sorted(step_prog.graphs), warm=dict(step_prog.warm),
                       step_replays=[g.replays for g in graphs if g.state is not None],
                       forward_replays=[g.replays for g in graphs if g.state is None],
                       agreed=agreed)
    finally:
        mp.undo()
    return run


def rank_main(mesh, job: dict, root: str) -> dict:
    """Every part's runs on this rank (the module docstring's (a)-(f))."""
    ramp, off = model_cfg(RAMP), model_cfg({"kind": None})
    sd = weights(ramp)
    out = {"backend": mesh.backend}
    out["fit"] = {p: fit_run(mesh, ramp, sd, p, root, f"ramp{p}") for p in (True, False)}
    out["expected_fills"] = expected_fills(mesh, FIT["seed"], FIT["max_epochs"])
    out["lr_find"] = {p: lr_find_run(mesh, ramp, sd, p) for p in (True, False)}
    out["fit_start"] = sd
    out["jax_fit"] = fit_run(mesh, off, job["fit_state_dict"], True, root, "jax")
    bn = model_cfg(RAMP, norm="batch", remat=True)
    out["batch_norm"] = {p: fit_run(mesh, bn, weights(bn), p, root, f"bn{p}", max_epochs=1)
                         for p in (True, False)}
    out["mc"] = {p: mc_run(mesh, job["mc_own"], p) for p in (True, False)}
    out["mc_jax"] = {p: mc_run(mesh, job["mc_jax"], p, job["mc_jax"]["keys"])[0]
                     for p in (True, False)}
    out["card"] = card_schedule_run(mesh, ramp, sd, root)
    out["agree"] = {}
    for name, key in (("same", (-1, 2)), ("differ", (-1, mesh.rank))):
        try:
            tmesh.agree(key, mesh)
            out["agree"][name] = "agreed"
        except RuntimeError as e:
            out["agree"][name] = str(e)
    return out


_WORKER = r"""
import sys

import torch

rank, world, port, job_path, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
sys.path.insert(0, "tests")
import test_torch_mesh_program as t
from unet_research_tpu_torch.parallel.mesh import make_mesh, multihost_initialize

multihost_initialize(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
mesh = make_mesh(device="cpu")
job = torch.load(job_path, weights_only=False)
torch.save(t.rank_main(mesh, job, out_path + ".runs"), out_path)
"""


def _test_module(name: str):
    """A sibling test module's helpers (it imports the JAX package, which
    the rank processes do not need)."""
    sys.path.insert(0, str(TESTS))
    return __import__(name)


def _jax_fit(tmp_path):
    """JAX's fit of FIT on its 2-device mesh, DropBlock off, and its
    initial weights as the port's state_dict."""
    import jax
    import jax.numpy as jnp

    import unet_research_tpu.models.unet as junet
    from unet_research_tpu.data.dataset import ArrayDataset as JArrayDataset
    from unet_research_tpu.parallel import make_mesh as jmake_mesh
    from unet_research_tpu.train import POLICIES as JPOLICIES
    from unet_research_tpu.train import Trainer as JTrainer
    from unet_research_tpu.train import TrainerConfig as JTrainerConfig

    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=None), **SMALL)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    jt = JTrainer(junet.UNet(jcfg), JPOLICIES["none"], JTrainerConfig(**FIT),
                  mesh=jmake_mesh(data=2))

    def jds(n, seed):
        ds = dataset(n, seed)
        return JArrayDataset(ds.images, ds.targets, ds.masks)

    state, history, _ = jt.fit(jds(N_TRAIN, 1), jds(N_VAL, 2), str(tmp_path / "jax"),
                               params=variables["params"])
    final = jax_params_to_state_dict({"params": state.params}, jcfg)
    return jax_params_to_state_dict(variables, jcfg), history, final


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's references and the two ranks' runs (one pair of rank processes
    for the module)."""
    tm = _test_module("test_torch_mesh")
    tmp = tmp_path_factory.mktemp("mesh_program")
    sd, jhistory, jfinal = _jax_fit(tmp)
    mp = pytest.MonkeyPatch()
    try:
        jmc_job, jmc = tm._jax_mc(8, mp)
    finally:
        mp.undo()
    db = dict(kind="independent", block_size=3, use_scheduler=False)
    small = dict(filters=4, model_depth=2, group_norm_groups=2)
    im = np.random.default_rng(2).random((1, 16, 20, 1), dtype=np.float32)
    job = {"fit_state_dict": sd,
           "mc_own": {"db": db, "over": small, "mc": MC, "im": im, "ones": np.ones_like(im),
                      "state_dict": weights(model_cfg(db, **small), 4)},
           "mc_jax": {"db": jmc_job["db"], "over": jmc_job["cfg"], "keys": jmc_job["keys"],
                      "mc": dict(num_iterations=16, return_num=0, chunk=8),
                      "im": jmc_job["im"], "ones": jmc_job["ones"],
                      "state_dict": jmc_job["state_dict"]}}
    path = tmp / "job.pt"
    torch.save(job, path)
    return tm.run_ranks(_WORKER, path, timeout=420), (jhistory, jfinal), jmc


def _same_fit(a: dict, b: dict) -> None:
    assert a["step"] == b["step"]
    np.testing.assert_equal(a["history"], b["history"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for x, y in zip(a["momentum"], b["momentum"]):
        assert torch.equal(x, y)
    assert torch.equal(a["keys"], b["keys"])


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_fit_program_equals_host_steps(ranks, rank):
    """(a) Each rank's program fit equals its program=False fit bit for bit;
    its tables hold, epoch by epoch, shard_batch's rows of the shared
    shuffled order (2 and 1 rows of the batches of 4 and 2), and nothing
    captures on the CPU."""
    run = ranks[0][rank]
    prog, host = run["fit"][True], run["fit"][False]
    _same_fit(prog, host)
    assert prog["step"] == 4 and host["fills"] == []
    got = [[order[k, :n].tolist() for k, n in enumerate(rows)] for order, rows in prog["fills"]]
    assert got == run["expected_fills"]
    assert [rows for _, rows in prog["fills"]] == [[2, 1]] * 2
    assert not prog["captures_steps"] and not prog["captures_forwards"]


def test_mesh_fits_are_the_same_on_both_ranks(ranks):
    a, b = (r["fit"][True] for r in ranks[0])
    assert a["history"] == b["history"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    assert a["fills"][0][0].tolist() != b["fills"][0][0].tolist()  # each rank its own rows


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_lr_find_program_equals_host_steps(ranks, rank):
    """(a) lr_find's 14 steps under the mesh: the same losses (global, read
    after every step), suggestion, key generator and weights put back."""
    prog, host = ranks[0][rank]["lr_find"][True], ranks[0][rank]["lr_find"][False]
    assert len(prog["losses"]) == 14 and prog["losses"] == host["losses"]
    assert prog["lr"] == host["lr"]
    assert torch.equal(prog["keys"], host["keys"])
    for k, v in prog["state_dict"].items():
        assert torch.equal(v, host["state_dict"][k]), k
        assert torch.equal(v, ranks[0][0]["fit_start"][k]), k


def test_mesh_program_fit_matches_jax_mesh(ranks):
    """(b) The program fit on two ranks, DropBlock off, against JAX's fit on
    its 2-device mesh from the same weights and seed."""
    runs, (jhistory, jfinal), _ = ranks
    got = runs[0]["jax_fit"]
    for name in ("train_loss_epoch", "val_loss_epoch"):
        np.testing.assert_allclose(got["history"][name], jhistory[name], rtol=2e-5, atol=2e-6,
                                   err_msg=name)
    assert got["history"]["lr"] == jhistory["lr"]
    for k, v in jfinal.items():
        np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_mc_program_equals_host_route(ranks, rank):
    """(c) 21 members, chunk 4, 3 saved: the saved 3 whole on every rank,
    4 body chunks through the program (2 members a rank and the gather),
    a remainder of 2 split; program and host route bit-equal, the same on
    both ranks, and nothing captured on the CPU."""
    (prog, program, captures, n_programs), (host, host_program, _, host_n) = (
        ranks[0][rank]["mc"][True], ranks[0][rank]["mc"][False])
    assert program and not captures and n_programs == 1
    assert not host_program and host_n == 0
    for a, b, c in zip(prog, host, ranks[0][1 - rank]["mc"][True][0]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert prog[2].shape == (3, 1, 16, 20, 1) and float(prog[1].max()) > 0.01


def test_mesh_mc_program_matches_jax_mesh(ranks):
    """(c) On JAX's per-chunk keys the program route and the host route
    are bit-equal, and both within test_mc_engine_split_matches_jax_mesh's
    tolerance of JAX's engine on its 8-device mesh."""
    runs, _, (mean, std) = ranks
    for run in runs:
        prog, host = run["mc_jax"][True], run["mc_jax"][False]
        assert all(torch.equal(a, b) for a, b in zip(prog, host))
        np.testing.assert_allclose(prog[0].numpy(), mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(prog[1].numpy(), std, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_batch_norm_program_equals_host_steps(ranks, rank):
    """(d) norm='batch' under remat: the batch moments' psum in the forward
    and its re-run, program against host bit for bit (running statistics
    included)."""
    _same_fit(*(ranks[0][rank]["batch_norm"][p] for p in (True, False)))
    assert any(k.endswith("running_var") for k in ranks[0][rank]["batch_norm"][True]["state_dict"])


@pytest.mark.parametrize("rank", [0, 1])
def test_mesh_card_schedule_agrees_and_equals_host(ranks, rank):
    """(f) The card's schedule under the mesh, with the graph stood in for:
    every key (size, rows per rank) warms up twice, then both ranks agree
    on it and capture it, the partial batch's its own; the replays give
    the host fit's numbers (4 epochs: 8 steps, 4 of them replays). Each
    rank's validation batch (2 rows) is captured after one warm-up with no
    agreement: the forward holds no collective."""
    run = ranks[0][rank]
    card = run["card"]
    assert card["graphs"] == [(-1, 1), (-1, 2)]
    assert card["warm"] == {(-1, 2): 2, (-1, 1): 2} and card["step_replays"] == [2, 2]
    assert card["forward_replays"] == [3]
    assert card["agreed"] == [repr((-1, 2)), repr((-1, 1))]
    assert card["agreed"] == ranks[0][1 - rank]["card"]["agreed"]
    assert card["step"] == 8 and np.isfinite(card["history"]["train_loss_epoch"]).all()


def test_ranks_that_hold_other_keys_all_raise(ranks):
    """parallel/mesh.py::agree: equal keys pass on both ranks; keys that
    differ raise on both, before any capture could wait for the other."""
    for run in ranks[0]:
        assert run["agree"]["same"] == "agreed"
        assert "would capture different graphs" in run["agree"]["differ"]
        assert run["backend"] == "gloo"


# (e) the capture decision -------------------------------------------------------

@pytest.mark.parametrize("backend,program,captures", [
    (None, True, True), ("nccl", True, True), ("gloo", True, False),
    (None, False, False), ("nccl", False, False)])
def test_capture_decision_on_a_card(backend, program, captures):
    """What a program would decide on a card, without one: it captures
    unless program=False, and work holding a mesh's collectives only under
    NCCL (none without a mesh; a mesh built by hand has no backend)."""
    mesh = None if backend is None else Mesh(None, 2, 1, 0, torch.device("cpu"), backend)
    assert launches.captures_on_card(program, mesh) is captures
    assert launches.captures_on_card(program) is program
    assert not launches.captures_on_card(True, Mesh(None, 2, 1, 0, torch.device("cpu")))


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_nothing_captures_on_the_cpu(backend):
    """On the CPU the trainer's steps and forwards and the engine's program
    decide against a capture under either backend; the programs are still
    the table routes (program=True)."""
    mesh = Mesh(None, 2, 1, 0, torch.device("cpu"), backend)
    model = tunet.UNet(model_cfg(RAMP), device="cpu")
    trainer = Trainer(model, POLICIES["none"], TrainerConfig(train_batch=2), mesh=mesh,
                      device="cpu")
    assert not trainer.captures_steps and not trainer.captures_forwards and trainer.program
    engine = MCDropBlockEngine(model, chunk=4, device="cpu", mesh=mesh)
    assert engine.program and not engine.captures


def test_collectives_are_counted_and_credited():
    """Each collective call adds one to its kind's count, which the launch
    snapshot carries: a capture's counts say how many collectives its graph
    holds, and credit adds them per replay."""
    import torch.distributed as dist

    port = _test_module("test_torch_mesh")._free_port()
    tmesh.multihost_initialize(f"tcp://127.0.0.1:{port}", 1, 0, backend="gloo")
    try:
        mesh = tmesh.make_mesh(device="cpu")
        before = launches.snapshot()
        tmesh.psum(torch.ones(2), mesh)
        tmesh.all_gather(torch.ones(1, 2), mesh)
        tmesh.all_reduce_grads_([torch.ones(3)], mesh)
        got = launches.since(before)
        assert got == {"collective:psum": 1, "collective:all_gather": 1,
                       "collective:all_reduce_grads": 1}
        launches.credit(got, 2)
        assert launches.since(before) == {k: 3 for k in got}
        launches.credit(got, -3)
        assert launches.since(before) == {}
    finally:
        dist.destroy_process_group()
