"""Port parity, multi-device: ``parallel/``, the renderer's ``sharding=``,
the sharded gradient steps and the CLI's ``--shard``, on the CPU.

Two ranks of a ``gloo`` process group are spawned once for the whole file
(a module-scoped fixture, ``spawn`` start method, the group initialised
through a store file, a timeout on every collective and on the join). Each
rank runs every case and saves what it got; the tests hold those results
against the port's single-process renders and gradients, and the pixel
split against the JAX package's single render as well. This module imports
no JAX at its top, so that the spawned ranks import only the port: the JAX
comparisons import it inside the test.

The cases are the ports of ``tests/test_parallel.py`` (pixel axis, spp axis,
uneven spp), of ``tests/test_integrators.py::
test_render_sharded_equals_single`` (here also the fused route's plain
version over a block, and a checkpoint written by two ranks and resumed on
one) and of the sharded gradient step of ``__graft_entry__.py``.
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

from xraytracer_tpu_torch import cli, diff, parallel
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.integrators import make_path_integrator
from xraytracer_tpu_torch.renderer import (
    Accumulator,
    WavefrontRenderer,
    make_sample_fn,
    pixel_grid,
    pixel_sharding,
    render,
)
from xraytracer_tpu_torch.scene.builder import scene_statics
from xraytracer_tpu_torch.scene.presets import build_cornell_box, cornell_camera

torch.set_num_threads(1)

WORLD = 2
RANK_TIMEOUT_S = 60     # every collective of a rank
JOIN_TIMEOUT_S = 180    # the parent's wait for both ranks
W, H = 32, 32           # tests/test_parallel.py's frame
RW, RH = 40, 30         # tests/test_integrators.py's frame
GW, GH = 16, 12         # the gradient steps' frame (test_torch_diff.py's)


def _cornell():
    tables = build_cornell_box().build(device="cpu")
    return tables, scene_statics(tables)


def _cam(w, h):
    return PinholeCamera.make(w / h, device="cpu", **cornell_camera())


def _forced(integrate, tables, st, max_depth):
    """The ``fused_spec`` a path integrator carries on the card, with
    ``force=True`` so that CPU tables take the whole-render route (its plain
    version)."""
    integrate.fused_spec = dict(
        scene=tables, statics=st, max_depth=max_depth, force=True, nee=True,
        le_depth0_only=True, cosine_sampling=False, nee_mode="all",
        pick_weights=None,
    )
    return integrate


def _grad_case():
    """Cornell at GW x GH, depth 2, albedo and emission overridden, a target
    from another sample: test_torch_diff.py's live-params case."""
    tables, st = _cornell()
    cam = _cam(GW, GH)
    radiance = diff.make_radiance_fn(tables, st, cam, GW, GH, max_depth=2,
                                     cosine_sampling=True, seed=0)
    ids, xy = pixel_grid(GW, GH, device="cpu")
    params = {"mat_albedo": tables.mat_albedo * torch.tensor([0.9, 0.8, 0.7]),
              "al_le": tables.al_le * 1.3}
    with torch.no_grad():
        target = 0.5 * radiance(params, ids, xy, 3)
    return tables, st, cam, radiance, ids, xy, params, target


def _grad_steps(group):
    """(loss, grads) of one autograd train step and of the analytic step,
    on ``group`` (None: one process)."""
    tables, st, cam, radiance, ids, xy, params, target = _grad_case()
    val, new, g = diff.make_train_step(radiance, lr=0.05, group=group)(
        params, ids, xy, target, 0)
    fast = diff.try_make_fast_value_and_grad(
        tables, st, cam, GW, GH, max_depth=2, force=True, group=group)
    val_f, g_f = fast(params, ids, xy, target, 0)
    out = {"train_loss": val.numpy(), "fast_loss": val_f.numpy()}
    for k in ("mat_albedo", "al_le"):
        out[f"train_{k}"] = g[k].numpy()
        out[f"train_new_{k}"] = new[k].numpy()
        out[f"fast_{k}"] = g_f[k].numpy()
    return out


def _rank_main(rank, store, out_dir):
    """One rank: join the group, run every case, save the results."""
    torch.set_num_threads(1)
    parallel.multihost_init(f"file://{store}", WORLD, rank, backend="gloo",
                            timeout=RANK_TIMEOUT_S)
    group = parallel.make_mesh("cpu")
    assert (group.rank, group.world, group.backend) == (rank, WORLD, "gloo")
    tables, st = _cornell()
    tables = parallel.replicated(group, tables)
    out = {}

    # tests/test_parallel.py: the pixel axis, the spp axis, uneven spp
    integ = make_path_integrator(tables, st, 2, nee=True)
    ids, xy = pixel_grid(W, H, device="cpu")
    for name, fn, spp, seed in (
        ("pixel_axis", parallel.shard_map_render, 3, 7),
        ("spp_axis", parallel.spp_parallel_render, 8, 7),
        ("spp_axis_again", parallel.spp_parallel_render, 8, 7),
        ("spp_uneven", parallel.spp_parallel_render, 5, 3),
    ):
        sample_once = make_sample_fn(tables, _cam(W, H), integ, W, H, seed=seed)
        acc, rej = fn(tables, sample_once, ids, xy, spp, group)
        out[name] = acc.numpy().reshape(H, W, 3) / spp
        out[f"{name}_rej"] = int(rej)

    # the renderer's pixel split: wavefront route, the fused route's plain
    # version, and a checkpoint of the whole frame written by rank 0
    sharding = pixel_sharding(group)
    integ2 = make_path_integrator(tables, st, 2, nee=True)
    out["render"] = render(tables, _cam(RW, RH), integ2, RW, RH, 2, seed=4,
                           sharding=sharding).image
    fused = _forced(make_path_integrator(tables, st, 2, nee=True), tables, st, 2)
    r = WavefrontRenderer(tables, _cam(RW, RH), fused, RW, RH, seed=4,
                          sharding=sharding)
    out["rank_block_lanes"] = r.pixel_ids.numpy()
    out["fused"] = r.render(2).image
    r = render(tables, _cam(RW, RH), integ2, RW, RH, 2, seed=3, spp_chunk=1,
               checkpoint_path=os.path.join(out_dir, "ckpt.npz"),
               sharding=sharding)
    out["ckpt_part"] = r.image

    out.update(_grad_steps(group))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, from one spawn of the group."""
    d = tmp_path_factory.mktemp("ranks")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, str(d / "store"), str(d)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    got = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    for k in got[0]:
        if not k.startswith("rank_"):
            # every rank returns the whole result, bit for bit the same
            np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    got[0]["rank_block_lanes"] = [g["rank_block_lanes"] for g in got]
    return got[0], str(d)


def _single(spp, seed, w=W, h=H, **kw):
    tables, st = _cornell()
    integ = make_path_integrator(tables, st, 2, nee=True)
    return render(tables, _cam(w, h), integ, w, h, spp, seed=seed, **kw)


def test_pixel_and_spp_axes_match_single(ranks):
    """tests/test_parallel.py's three cases: the pixel split is bitwise the
    port's single render and within the port-vs-JAX gate of the JAX single
    render; the spp split is within 1e-5 of single (other addition order)
    and bitwise the same in two runs, also for an spp the ranks do not
    divide."""
    got, _ = ranks
    from test_torch_slice import GATE

    from xraytracer_tpu.camera import PinholeCamera as JCamera
    from xraytracer_tpu.integrators import make_path_integrator as j_make_path
    from xraytracer_tpu.renderer import render as j_render
    from xraytracer_tpu.scene import builder as jbuilder
    from xraytracer_tpu.scene import presets as jpresets

    single = _single(3, 7)
    np.testing.assert_array_equal(got["pixel_axis"], single.image)
    assert got["pixel_axis_rej"] == 0
    jt = jpresets.build_cornell_box().build()
    jr = j_render(jt, JCamera.make(W / H, **jpresets.cornell_camera()),
                  j_make_path(jt, jbuilder.scene_statics(jt), 2, nee=True),
                  W, H, 3, seed=7)
    np.testing.assert_allclose(got["pixel_axis"], jr.image, **GATE)

    np.testing.assert_allclose(got["spp_axis"], _single(8, 7).image, atol=1e-5)
    np.testing.assert_array_equal(got["spp_axis"], got["spp_axis_again"])
    assert got["spp_axis_rej"] == 0
    np.testing.assert_allclose(got["spp_uneven"], _single(5, 3).image, atol=1e-5)


def test_render_sharded_equals_single(ranks):
    """``render(..., sharding=pixel_sharding(group))`` on the wavefront
    route and on the fused route's plain version over each rank's block,
    bitwise the single render; a checkpoint written by two ranks resumes on
    one, bitwise the straight render."""
    got, d = ranks
    tables, st = _cornell()
    np.testing.assert_array_equal(got["render"], _single(2, 4, RW, RH).image)
    fused = _forced(make_path_integrator(tables, st, 2, nee=True), tables, st, 2)
    single = WavefrontRenderer(tables, _cam(RW, RH), fused, RW, RH, seed=4)
    # each rank's view held its own contiguous block of the lanes
    np.testing.assert_array_equal(np.concatenate(got["rank_block_lanes"]),
                                  single.pixel_ids.numpy())
    assert got["rank_block_lanes"][0].shape == (RW * RH // 2,)
    np.testing.assert_array_equal(got["fused"], single.render(2).image)

    np.testing.assert_array_equal(got["ckpt_part"],
                                  _single(2, 3, RW, RH, spp_chunk=1).image)
    acc = Accumulator.load(os.path.join(d, "ckpt.npz"), device="cpu")
    assert acc.spp_done == 2 and acc.acc.shape == (RW * RH, 3)
    resumed = _single(4, 3, RW, RH, spp_chunk=1, accumulator=acc)
    np.testing.assert_array_equal(resumed.image,
                                  _single(4, 3, RW, RH, spp_chunk=1).image)


def test_sharded_gradients_match_single(ranks):
    """The autograd train step and the analytic step (K5's plain version)
    over two ranks against one process, within test_torch_diff.py's
    tolerances."""
    got, _ = ranks
    from test_torch_diff import GRAD_ATOL_REL, GRAD_RTOL, LOSS_RTOL

    want = _grad_steps(None)
    for route in ("train", "fast"):
        np.testing.assert_allclose(got[f"{route}_loss"], want[f"{route}_loss"],
                                   rtol=LOSS_RTOL)
        for k in ("mat_albedo", "al_le"):
            w = want[f"{route}_{k}"]
            np.testing.assert_allclose(
                got[f"{route}_{k}"], w, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_REL * max(1e-6, float(np.abs(w).max())))
    for k in ("mat_albedo", "al_le"):
        np.testing.assert_allclose(got[f"train_new_{k}"], want[f"train_new_{k}"],
                                   rtol=1e-5, atol=1e-7)


def test_cli_shard_in_a_world_of_one(monkeypatch, tmp_path):
    """``--shard`` with no launcher: a world of one, bitwise the unsharded
    CLI image."""
    images = []
    monkeypatch.setattr(cli, "write_image",
                        lambda path, img, gamma: images.append(img))
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    base = ["--preset", "cornellbox_gi", "--width", "24", "--height", "18",
            "--spp", "2", "--device", "cpu", "-o", str(tmp_path / "out.png")]
    assert cli.main(base) == 0
    assert cli.main(base + ["--shard"]) == 0
    assert len(images) == 2
    np.testing.assert_array_equal(images[0], images[1])
