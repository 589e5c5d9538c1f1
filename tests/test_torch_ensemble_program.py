"""The ensembles' device programs (uncertainty/ensemble.py::EnsembleProgram)
on the CPU, where the captured chunk step runs eagerly over the same
tables: the program route against the per-chunk route (`program=False`)
and against the JAX engines, K4's member tables, and the capture helper's
handling of the garbage collector (with a stand-in for the CUDA graph).

Tolerances: site keys, the model's inputs, member rows and the table
launch's plain version bit for bit; mean, std and saved 1e-6 between the
two routes (the same members merged in the same order; on the CPU they
come out equal); against the JAX engines the existing tests' tolerances
(MC 1e-5 on JAX's chunk keys, tests/test_torch_mc_dropblock.py; rotational
1e-4 / 2e-4, tests/test_torch_rotational.py)."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unet_research_tpu.models.unet as junet
from unet_research_tpu.uncertainty import RotationalEngine as JaxRotationalEngine
from unet_research_tpu.uncertainty.mc_dropblock import MCDropBlockEngine as JaxMCDropBlockEngine
from unet_research_tpu_torch.models import unet as tunet
from unet_research_tpu_torch.ops.cuda import launches
from unet_research_tpu_torch.ops.cuda import shear_rotate as sr
from unet_research_tpu_torch.uncertainty import MCDropBlockEngine, RotationalEngine, ensemble
from unet_research_tpu_torch.uncertainty import mc_dropblock
from unet_research_tpu_torch.uncertainty.ensemble import EnsembleProgram, chunk_layout
from unet_research_tpu_torch.utils.convert import jax_params_to_state_dict

SMALL = dict(filters=4, model_depth=2, group_norm_groups=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is faster here, and the suite runs
    several test processes side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _image(rng, h=20, w=18):
    im = rng.random((1, h, w, 1)).astype(np.float32)
    gt = (rng.random((1, h, w, 1)) > 0.5).astype(np.float32)
    mask = np.ones((1, h, w, 1), np.float32)
    mask[:, :3] = 0.0
    return im, gt, mask


def _record_forwards(model, key):
    """Wrap model.forward to record one tensor of each call (`key`: 'x',
    the batch, or 'site_keys')."""
    seen = []
    real = model.forward

    def spy(x, drop_prob=None, site_keys=None, **kw):
        seen.append((x if key == "x" else site_keys).clone())
        return real(x, drop_prob=drop_prob, site_keys=site_keys, **kw)

    model.forward = spy
    return seen


def _assert_stats_close(got, ref):
    for name, a, b in zip(("mean", "std", "saved"), got, ref):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


@pytest.mark.parametrize("members,return_num,chunk,resize", [
    (11, 2, 3, -1),   # saved 2, 3 body chunks, no remainder
    (12, 0, 3, -1),   # the first chunk outside, 3 body chunks, no remainder
    (13, 0, 3, 16),   # the first chunk outside, 3 body chunks, a remainder of 1, resize
    (14, 3, 4, -1),   # saved 3, 2 body chunks, a remainder of 3
    (9, 0, 2, -1),    # the first chunk outside, 3 body chunks, a remainder of 1
])
def test_mc_program_equals_per_chunk_route(rng, members, return_num, chunk, resize):
    """One generator seed: the same site keys for every chunk, bit for bit,
    the same draws from the generator, and the same statistics."""
    im, gt, mask = _image(rng)
    cfg = tunet.canonical_config(**SMALL)
    runs = {}
    for program in (True, False):
        model = tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
        seen = _record_forwards(model, "site_keys")
        gen = torch.Generator().manual_seed(5)
        engine = MCDropBlockEngine(model, num_iterations=members, return_num=return_num,
                                   resize=resize, chunk=chunk, device="cpu", program=program)
        out = engine.predict(im, gt, mask, 0.15, generator=gen)
        runs[program] = (out, seen, gen.get_state(), engine)
    (got, keys, state, engine), (ref, ref_keys, ref_state, _) = runs[True], runs[False]
    layout = chunk_layout(members, chunk, return_num)
    assert layout.n_body >= 2 and len(keys) == len(ref_keys) == len(layout.sizes)
    assert all(torch.equal(a, b) for a, b in zip(keys, ref_keys))
    assert torch.equal(state, ref_state)
    _assert_stats_close(got[:3], ref[:3])
    for a, b in zip(got[3:], ref[3:]):
        assert torch.equal(a, b)
    (prog,) = engine.programs.values()
    assert prog.graph is None and int(prog.index) == layout.n_body
    assert prog.count.dtype == torch.float32
    assert float(prog.count) == sum(layout.sizes[:layout.body_start + layout.n_body])


def test_mc_program_is_cached_per_drop_prob_and_shape(rng):
    im, gt, mask = _image(rng)
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu")
    engine = MCDropBlockEngine(model, num_iterations=10, return_num=0, chunk=3, device="cpu")
    engine.predict(im, gt, mask, 0.15)
    (prog,) = engine.programs.values()
    engine.predict(im, gt, mask, 0.15)
    assert list(engine.programs.values()) == [prog]
    engine.predict(im, gt, mask, 0.1)
    engine.predict(*_image(rng, 16, 18), 0.15)
    assert len(engine.programs) == 3


def test_mesh_engine_runs_every_chunk_from_the_host():
    """Under a mesh the engine keeps its program (its chunk step is the
    split chunk and its all_gather), but on the CPU, as under gloo, every
    chunk is launched from the host: nothing captures."""
    from unet_research_tpu_torch.parallel import Mesh

    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu")
    mesh = Mesh(None, 2, 1, 0, torch.device("cpu"), backend="gloo")
    engine = MCDropBlockEngine(model, chunk=4, device="cpu", mesh=mesh)
    assert engine.program and not engine.captures
    assert MCDropBlockEngine(model, chunk=4, device="cpu").program


@pytest.mark.parametrize("kind,resize", [("independent", 16)])
def test_mc_program_matches_jax_engine_on_its_chunk_keys(monkeypatch, rng, kind, resize):
    """10 members, none saved, chunk 3: JAX's first chunk outside its scan,
    2 scanned chunks and a remainder of 1; the port's program runs the 2 on
    JAX's chunk keys (recorded as in test_engine_matches_jax_engine_on_
    its_chunk_keys, which runs the dependent kind through the program with
    2 members saved)."""
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=kind, block_size=3),
                                  **SMALL)
    tcfg = tunet.canonical_config(
        dropblock=tunet.DropBlockConfig(kind=kind, block_size=3, mask_impl="fused"), **SMALL)
    im, gt, mask = _image(rng, 20, 18)
    variables = junet.UNet(jcfg).init(jax.random.PRNGKey(2), jnp.asarray(im))
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(variables, jcfg))

    calls = []
    for name in ("dropblock_dependent", "dropblock_independent"):
        real = getattr(junet, name)

        def spy(x_, key, *a, _real=real, **k):
            calls.append(np.asarray(jax.random.key_data(key)).reshape(-1).astype(np.int64))
            return _real(x_, key, *a, **k)

        monkeypatch.setattr(junet, name, spy)
    engine = JaxMCDropBlockEngine(junet.UNet(jcfg), num_iterations=10, return_num=0,
                                  resize=resize, chunk=3)
    with jax.disable_jit():
        ref = engine.predict(variables["params"], im, gt, mask, jax.random.PRNGKey(9), 0.15)
    sites = model.num_mask_sites()
    # unjitted, JAX's scan runs its body per chunk, on concrete keys
    assert len(calls) == len(chunk_layout(10, 3, 0).sizes) * sites == 4 * sites
    chunk_keys = iter(torch.from_numpy(np.stack(calls)).split(sites))
    monkeypatch.setattr(mc_dropblock, "draw_site_keys", lambda n, generator: next(chunk_keys))
    got = MCDropBlockEngine(model, num_iterations=10, return_num=0, resize=resize, chunk=3,
                            device="cpu").predict(im, gt, mask, 0.15)
    for name, a, b in zip(("mean", "std", "saved"), got[:3], ref[:3]):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, err_msg=name)
    assert float(got[1].max()) > 0.01


def _rot_model():
    cfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **SMALL)
    return tunet.UNet(cfg, device="cpu", generator=torch.Generator().manual_seed(2)).eval()


@pytest.mark.parametrize("warp", ["gather", "shear"])
@pytest.mark.parametrize("members,return_num,chunk,resize", [
    (11, 2, 3, -1), (12, 0, 3, -1), (14, 3, 4, 16)])
def test_rotational_program_equals_per_chunk_route(rng, warp, members, return_num, chunk,
                                                   resize):
    """The model sees the same warped batches, bit for bit ('shear' through
    the table launch's plain version in the program), and the statistics
    are the same."""
    im, gt, mask = _image(rng, 20, 17)
    runs = {}
    for program in (True, False):
        model = _rot_model()
        seen = _record_forwards(model, "x")
        engine = RotationalEngine(model, num_iterations=members, return_num=return_num,
                                  resize=resize, chunk=chunk, warp=warp, device="cpu",
                                  program=program)
        runs[program] = (engine.predict(im, gt, mask), seen, engine)
    (got, xs, engine), (ref, ref_xs, _) = runs[True], runs[False]
    layout = chunk_layout(members, chunk, return_num)
    assert layout.n_body >= 2 and len(xs) == len(ref_xs) == len(layout.sizes)
    assert all(torch.equal(a, b) for a, b in zip(xs, ref_xs))
    _assert_stats_close(got[:3], ref[:3])
    (prog,) = engine.programs.values()
    assert int(prog.index) == layout.n_body


@pytest.mark.parametrize("warp", ["gather", "shear"])
def test_rotational_program_matches_jax(warp):
    """13 angles, none saved, chunk 4: JAX's first chunk outside its scan,
    2 scanned chunks, a remainder of 1 (the JAX shear warp's Pallas kernel
    in interpret mode); the tolerances of test_engine_matches_jax."""
    small = dict(filters=8, model_depth=2, group_norm_groups=4)
    jcfg = junet.canonical_config(dropblock=junet.DropBlockConfig(kind=None), **small)
    jmodel = junet.UNet(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    tcfg = tunet.canonical_config(dropblock=tunet.DropBlockConfig(kind=None), **small)
    model = tunet.UNet(tcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(variables, jcfg))
    rng = np.random.default_rng(13)
    im = rng.random((1, 32, 32, 1), dtype=np.float32)
    yy, xx = np.mgrid[:32, :32]
    mask = (((yy - 15.5) ** 2 + (xx - 15.5) ** 2) <= 256).astype(np.float32)[None, :, :, None]
    jmean, jstd, jsaved, *_ = JaxRotationalEngine(
        jmodel, num_iterations=13, return_num=0, chunk=4, warp=warp).predict(
        variables["params"], jnp.asarray(im), jnp.asarray(im), jnp.asarray(mask))
    engine = RotationalEngine(model.eval(), num_iterations=13, return_num=0, chunk=4, warp=warp,
                              device="cpu")
    mean, std, saved, *_ = engine.predict(im, im, mask)
    assert len(engine.programs) == 1 and saved.shape == (0, 1, 32, 32, 1) == jsaved.shape
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0, atol=1e-4)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=0, atol=2e-4)
    assert float(std.max()) > 0


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_member_table_equals_per_chunk_fan_params(sign):
    """The rotational engine's table for 1..359 (25 saved, chunk 16: the
    20 body chunks) and its negation, at 584x565: each chunk's rows equal
    the rows rotate_fan computes for that chunk's angles, bit for bit, and
    read back as its scalars; the table's window_limits bound every
    chunk's own limits and every tile's windows (the kernel's trap)."""
    h, w = 584, 565
    layout = chunk_layout(359, 16, 25)
    angles = torch.arange(1, 360, dtype=torch.float32)
    first = sum(layout.sizes[:layout.body_start])
    chunks = [sign * angles[first + 16 * c:first + 16 * (c + 1)] for c in range(layout.n_body)]
    table = sr.member_table(chunks, h, w, "cpu")
    assert table.chunks == layout.n_body == 20 and table.members == 16
    assert table.rows.dtype == torch.int32 and table.rows.shape == (320, 6)
    cols, rows, canvas = table.limits
    for c, a in enumerate(chunks):
        p = sr.fan_params(a, h, w)
        assert torch.equal(table.rows[16 * c:16 * (c + 1)], sr.member_rows(p))
        back = sr.table_params(table, torch.tensor([c]))
        for name in ("qm", "r", "t1", "q", "s", "t2"):
            assert torch.equal(getattr(back, name), getattr(p, name)), name
        own = sr.window_limits(p, sr.canvas_size(h, w))
        assert all(x <= y for x, y in zip(own, table.limits))
        win = sr.tile_windows(p, h, w)
        assert int((win.c1 - win.c0 + 1).max()) <= cols
        assert int((win.r1 - win.r0 + 1).max()) <= rows
        assert int((win.v1 - win.v0 + 1).max()) <= canvas


def test_member_table_needs_equal_chunks():
    with pytest.raises(ValueError, match="one size"):
        sr.member_table([torch.arange(4.0), torch.arange(3.0)], 20, 20, "cpu")


@pytest.mark.parametrize("fan", ["forward", "inverse"])
def test_table_launch_plain_equals_rotate_fan(rng, fan):
    """rotate_fan_table on CPU tensors (its plain version) equals rotate_fan
    of each chunk's angles bit for bit, at every index, for one image
    (forward fan) and a batch of K (inverse fan); the ties 45 + 90k
    included."""
    chunks = [torch.tensor([45.0, 135.0, 225.0, 315.0]), torch.tensor([1.0, 90.0, 200.5, 359.0]),
              torch.tensor([-30.0, 17.0, 180.0, 270.0])]
    n = 1 if fan == "forward" else 4
    img = torch.from_numpy(rng.random((n, 21, 17, 1), dtype=np.float32))
    table = sr.member_table(chunks, 21, 17, "cpu")
    for c, angles in enumerate(chunks):
        got = sr.rotate_fan_table(img, table, torch.tensor([c]))
        assert torch.equal(got, sr.rotate_fan(img, angles))
    with pytest.raises(IndexError):
        sr.rotate_fan_table(img, table, torch.tensor([3]))
    with pytest.raises(ValueError, match="table's fan"):
        sr.rotate_fan_table(img[:, :20], table, torch.tensor([0]))


def test_count_is_a_float32_tensor():
    outs = torch.rand((3, 4, 2))
    count, mean, m2 = ensemble._batch_stats(outs)
    assert count.dtype == torch.float32 and count.shape == () and float(count) == 3.0
    merged = ensemble._merge((count, mean, m2), ensemble._batch_stats(outs[:2]))
    assert merged[0].dtype == torch.float32 and float(merged[0]) == 5.0


@pytest.mark.parametrize("fails", [False, True])
def test_capture_collects_first_and_holds_the_collector_off(monkeypatch, fails):
    """launches.capture, with a stand-in for the CUDA graph: the cyclic
    garbage is freed before the step, the collector is off during it and on
    again after it (also when the step raises), and the launch counts of
    the capture come back as the replay's and are taken back."""
    recorded = []

    class FakeGraph:
        def __init__(self, graph):
            recorded.append(graph)

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "graph", FakeGraph)

    class Cycle:
        pass

    garbage = Cycle()
    garbage.cycle = garbage
    dead = weakref.ref(garbage)
    del garbage
    seen = {}

    def step():
        seen["collected"], seen["collector_on"] = dead() is None, gc.isenabled()
        sr.rotate_fan_table.launches += 2
        if fails:
            raise RuntimeError("capture failed")

    before = sr.rotate_fan_table.launches
    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            launches.capture(step)
        sr.rotate_fan_table.launches = before
    else:
        graph, counts, seconds = launches.capture(step)
        assert graph is recorded[0] and counts == {"rotate_fan_table": 2} and seconds >= 0
    assert seen == {"collected": True, "collector_on": False}
    assert gc.isenabled() and sr.rotate_fan_table.launches == before


@pytest.mark.parametrize("engine", ["mc", "rotational-gather", "rotational-shear"])
def test_a_dropped_engine_frees_its_program_at_once(rng, engine):
    """An engine's cached program (on the card: its CUDA graph and the
    graph's private memory pool) goes with the engine, without waiting for
    the cyclic garbage collector: a program that kept its engine alive
    held tens of GiB of device memory after the engine was dropped, until
    the collector ran (a ladder of engines in one process ran out)."""
    model = tunet.UNet(tunet.canonical_config(**SMALL), device="cpu").eval()
    im, gt, mask = _image(rng)
    enabled = gc.isenabled()
    gc.disable()
    try:
        if engine == "mc":
            eng = MCDropBlockEngine(model, num_iterations=7, return_num=0, chunk=2, device="cpu")
            eng.predict(im, gt, mask, 0.1)
        else:
            eng = RotationalEngine(model, num_iterations=7, return_num=0, chunk=2,
                                   warp=engine.split("-")[1], device="cpu")
            eng.predict(im, gt, mask)
        (prog,) = eng.programs.values()
        ref = weakref.ref(prog)
        del prog, eng
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_program_steps_eagerly_on_the_cpu():
    """A program on the CPU runs its n steps eagerly from the given
    statistics and leaves the index at n; nothing is captured."""
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)

    def members(p):
        return p.image * p.row("values")[:, None, None, None]

    prog = EnsembleProgram(members, (1, 2, 2, 1), {"values": table}, torch.device("cpu"))
    prog.image.fill_(1.0)
    first = torch.full((2, 2, 2, 1), 5.0)
    stats = ensemble._batch_stats(first)
    count, mean, m2 = prog.run(stats, 4)
    everything = torch.cat([first, table.reshape(-1)[:, None, None, None].expand(12, 2, 2, 1)])
    assert float(count) == 14.0 and int(prog.index) == 4 and prog.graph is None
    torch.testing.assert_close(mean, everything.mean(0), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(m2, ((everything - everything.mean(0)) ** 2).sum(0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("total,chunk,return_num,sizes,body", [
    (10, 3, 0, [3, 3, 3, 1], (1, 2)), (11, 3, 2, [2, 3, 3, 3], (1, 3)),
    (5, 8, 0, [5], (0, 0)), (4, 2, 4, [4], (1, 0)), (7, 3, 0, [3, 3, 1], (1, 1))])
def test_chunk_layout_is_jaxs(total, chunk, return_num, sizes, body):
    layout = chunk_layout(total, chunk, return_num)
    assert layout.sizes == sizes and (layout.body_start, layout.n_body) == body
