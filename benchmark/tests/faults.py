"""Faults planted under the timed path, for the tests: each leaves the
harness as it is and breaks what the program returns."""

import numpy as np
import torch


# the fit's first steps (``traffic/grad.json``'s ``first_steps``)
LATE_AFTER = 3


def apply(name):
    if name is None:
        return
    if name.startswith("grad."):
        return _apply_grad(name[5:])
    from xraytracer_tpu_torch import renderer

    orig = renderer.WavefrontRenderer.render

    if name == "state_unchanged":
        # the accumulator comes back as it was handed in: an empty image
        def render(self, spp, *a, **k):
            res = orig(self, spp, *a, **k)
            res.image = np.zeros_like(res.image)
            return res
    elif name == "half_batch":
        # half of the samples left out, the mean taken over the rest
        def render(self, spp, *a, **k):
            res = orig(self, max(spp // 2, 1), *a, **k)
            res.spp = spp
            return res
    elif name == "answer_altered":
        # each frame's sums one percent off where they are produced
        def render(self, spp, *a, **k):
            res = orig(self, spp, *a, **k)
            res.image = res.image * np.float32(1.01)
            return res
    elif name == "no_exchange":
        # the gather of the finished blocks left out: each rank keeps its
        # own block in place and zeros elsewhere
        def gather_rows(group, t, sizes=None):
            sizes = sizes or [t.shape[0]] * group.world
            out = t.new_zeros((sum(sizes),) + tuple(t.shape[1:]))
            start = sum(sizes[:group.rank])
            out[start:start + t.shape[0]] = t
            return out

        renderer.gather_rows = gather_rows
        return
    else:
        raise ValueError(name)
    renderer.WavefrontRenderer.render = render


def _apply_grad(name):
    """The same faults in the density-fitting step (``step_pair``);
    ``late.<fault>``: only from the call after the fit's first steps on, so
    that the timed steps alone are broken."""
    from xraytracer_tpu_torch.integrators import het_megakernel

    orig_make = het_megakernel.try_make_fused_het_value_and_grad
    after = 0
    if name.startswith("late."):
        name, after = name[5:], LATE_AFTER

    def make(*a, **k):
        step = orig_make(*a, **k)
        orig_pair = step.step_pair
        calls = [0]

        def step_pair(params, ids, xy, target, sa, sb, aux=None):
            calls[0] += 1
            if calls[0] <= after:
                return orig_pair(params, ids, xy, target, sa, sb, aux=aux)
            if name == "half_batch":
                # half of the pixels left out, the mean taken over the rest
                h = ids.shape[0] // 2
                loss, grads = orig_pair(params, ids[:h], xy[:h], target[:h], sa, sb, aux=aux)
                if aux is not None:
                    aux["img"] = torch.cat([aux["img"], aux["img"]])
                    aux["img_b"] = torch.cat([aux["img_b"], aux["img_b"]])
                return loss, grads
            loss, grads = orig_pair(params, ids, xy, target, sa, sb, aux=aux)
            if name == "state_unchanged":
                # the step moves nothing
                grads = {k: torch.zeros_like(v) for k, v in grads.items()}
            elif name == "answer_altered":
                # the gradient one percent off where it is produced
                grads = {k: v * 1.01 for k, v in grads.items()}
            else:
                raise ValueError(name)
            return loss, grads

        step.step_pair = step_pair
        return step

    het_megakernel.try_make_fused_het_value_and_grad = make
