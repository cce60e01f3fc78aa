"""The port's spans (``xraytracer_tpu_torch.tracing``): off, ``span`` is one
shared no-op object; under ``torch.profiler`` and under ``record()`` a
render and a gradient step emit every span of their layers once, nested
as the call nests them, the top span carrying the frame's seed or the
step's sample indices; and the spans change no bit of an image or a
gradient. The render and the step run their plain versions on the CPU
(``force=True``) at a few pixels."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xraytracer_tpu_torch import tracing
from xraytracer_tpu_torch.camera import PinholeCamera
from xraytracer_tpu_torch.integrators import het_megakernel as hk
from xraytracer_tpu_torch.integrators import make_path_integrator
from xraytracer_tpu_torch.math import from_rows
from xraytracer_tpu_torch.parallel import PixelGroup
from xraytracer_tpu_torch.renderer import pixel_grid, render
from xraytracer_tpu_torch.scene import presets
from xraytracer_tpu_torch.scene.builder import scene_statics

W, H = 6, 4

# span -> its parent, as the call nests them (None: the call's top span)
RENDER_SPANS = {
    "renderer.render": None,
    "renderer.build": "renderer.render",
    "renderer.pixel_grid": "renderer.build",
    "renderer.route": "renderer.build",
    "renderer.launch": "renderer.render",
    "parallel.assemble": "renderer.render",
    "renderer.wait": "renderer.render",
    "renderer.readback": "renderer.render",
    "renderer.scatter": "renderer.render",
}
PAIR_SPANS = {
    "grad.step_pair": None,
    "grad.pack": "grad.step_pair",
    "grad.camera_rays": "grad.step_pair",
    "grad.pass_a": "grad.step_pair",
    "grad.loss": "grad.step_pair",
    "grad.pass_b": "grad.step_pair",
}


def _traced(fn):
    """``fn()`` under the profiler (shapes recorded, so a span's args are
    its inputs) and ``record()`` together: (result, the profiler's spans,
    the record's spans as ``_nesting`` gives them, the profiler's count of
    each span)."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with tracing.record() as kept:
            out = fn()
    # the raw events: building the profiler's event tree takes seconds here
    ours = [(e.name(), tuple(e.concrete_inputs()), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    by_profiler = {}
    for name, args, s, e in ours:
        holders = [k for k in ours if k[2] <= s and e <= k[3] and k != (name, args, s, e)]
        parent = max(holders, key=lambda k: k[2])[0] if holders else None
        by_profiler[name] = (parent, args)
    counts = {}
    for name, *_ in ours:
        counts[name] = counts.get(name, 0) + 1
    return out, by_profiler, _nesting(kept), counts


def _nesting(kept):
    """name -> (parent, args) from ``record()``'s spans (a parent is the
    span one level up whose interval holds the child)."""
    out = {}
    for name, args, s, e, depth in kept:
        holders = [k for k in kept if k[4] == depth - 1 and k[2] <= s and e <= k[3]]
        out[name] = (holders[0][0] if holders else None, args)
    return out


@pytest.fixture(scope="module")
def cornell():
    tables = presets.build_cornell_box().build(device="cpu")
    st = scene_statics(tables)
    integ = make_path_integrator(tables, st, 2, nee=True)
    # the spec it would carry on the card; force=True takes CPU tables
    integ.fused_spec = dict(scene=tables, statics=st, max_depth=2, force=True, nee=True,
                            le_depth0_only=True, cosine_sampling=False, nee_mode="all",
                            pick_weights=None)
    cam = PinholeCamera.make(W / H, device="cpu", **presets.cornell_camera())
    one = PixelGroup(0, 1, torch.device("cpu"))   # a split over a world of one

    def frame():
        return render(tables, cam, integ, W, H, 2, seed=5, sharding=one)

    off = frame()
    on, by_profiler, by_record, counts = _traced(frame)
    return off, on, by_profiler, by_record, counts


@pytest.fixture(scope="module")
def cloud():
    g = np.zeros((16, 16, 16), np.float32)
    g[3:13, 3:13, 3:13] = np.random.default_rng(7).uniform(0.3, 1.0, (10, 10, 10))
    tables = presets.build_volume_scene(
        res=g.shape, density=g, absorption=(0.02, 0.03, 0.04),
        scattering=(0.10, 0.08, 0.06), le=25.0, light_center=(0.0, 400.0, 0.0),
    ).build("cpu")
    c2w = from_rows(1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0, 0, 60.0, 520.0, 1)
    cam = PinholeCamera.make(W / H, c2w=c2w, fov_deg=60.0, device="cpu")
    step = hk.try_make_fused_het_value_and_grad(
        tables, scene_statics(tables), cam, W, H, 1, nee=True, max_steps=8, force=True)
    ids, xy = pixel_grid(W, H, device="cpu")
    grid = torch.from_numpy(g)
    target = step.render(grid, ids, xy, 9)

    def pair():
        return step.step_pair({"grid_density": grid * 0.8}, ids, xy, target, 4, 5)

    off = pair()
    on, by_profiler, by_record, counts = _traced(pair)
    return dict(step=step, ids=ids, xy=xy, grid=grid, target=target, off=off, on=on,
                by_profiler=by_profiler, by_record=by_record, counts=counts)


def test_off_span_is_one_shared_object():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("renderer.render", (1,)), tracing.span("grad.pack")
    assert a is b is tracing.OFF
    with a as got:
        assert got is None


def test_record_keeps_nesting_times_and_args():
    with tracing.record() as kept:
        with tracing.span("a.top", (3, 4)):
            with tracing.span("a.child"):
                pass
            with tracing.span("a.other"):
                pass
        with tracing.record() as inner:          # a record inside a record
            with tracing.span("b.top"):
                pass
        with tracing.span("a.last"):
            pass
    assert tracing.span("x.y") is tracing.OFF     # closed again
    assert [(n, a, d) for n, a, _, _, d in kept] == [
        ("a.child", (), 1), ("a.other", (), 1), ("a.top", (3, 4), 0), ("a.last", (), 0)]
    assert [(n, d) for n, _, _, _, d in inner] == [("b.top", 0)]
    assert all(s <= e for _, _, s, e, _ in kept)
    top = kept[2]
    assert all(top[2] <= s and e <= top[3] for _, _, s, e, _ in kept[:2])


def test_span_closes_on_an_exception():
    with tracing.record() as kept:
        with pytest.raises(ValueError):
            with tracing.span("a.fails"):
                raise ValueError("inside")
        with tracing.span("a.after"):
            pass
    assert [(n, d) for n, _, _, _, d in kept] == [("a.fails", 0), ("a.after", 0)]


@pytest.mark.parametrize("sink", ["profiler", "record"])
def test_render_emits_every_span_once(cornell, sink):
    _, _, by_profiler, by_record, counts = cornell
    got = by_profiler if sink == "profiler" else by_record
    assert {k: v[0] for k, v in got.items()} == RENDER_SPANS
    assert got["renderer.render"][1] == (5,)
    if sink == "profiler":
        assert counts == dict.fromkeys(RENDER_SPANS, 1)


def test_render_is_bitwise_with_spans_on(cornell):
    off, on = cornell[:2]
    assert np.array_equal(off.image, on.image) and off.image.sum() > 0
    assert off.n_rejected == on.n_rejected


@pytest.mark.parametrize("sink", ["profiler", "record"])
def test_step_pair_emits_every_span_once(cloud, sink):
    got = cloud["by_profiler" if sink == "profiler" else "by_record"]
    assert {k: v[0] for k, v in got.items()} == PAIR_SPANS
    assert got["grad.step_pair"][1] == (4, 5)
    if sink == "profiler":
        assert cloud["counts"] == dict.fromkeys(PAIR_SPANS, 1)


def test_step_pair_is_bitwise_with_spans_on(cloud):
    (loss0, g0), (loss1, g1) = cloud["off"], cloud["on"]
    assert torch.equal(loss0, loss1)
    assert g0.keys() == g1.keys() == {"grid_density"}
    assert torch.equal(g0["grid_density"], g1["grid_density"])
    assert float(g0["grid_density"].abs().sum()) > 0


def test_step_and_render_image_reuse_the_inner_spans(cloud):
    c = cloud
    with tracing.record() as kept:
        c["step"]({"grid_density": c["grid"]}, c["ids"], c["xy"], c["target"], 3)
        c["step"].render(c["grid"], c["ids"], c["xy"], 7)
    got = _nesting(kept)
    names = [k[0] for k in kept]
    assert names.count("grad.camera_rays") == names.count("grad.pass_a") == 2
    assert names.count("grad.pack") == 2
    assert got["grad.step"] == (None, (3,)) and got["grad.render"] == (None, (7,))
    assert {n for n, _, _, _, d in kept if d == 1} == {
        "grad.pack", "grad.camera_rays", "grad.pass_a", "grad.loss", "grad.pass_b"}
