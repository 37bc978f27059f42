"""The faults of the ``ti2v`` job kind: the denoise job's (``faults.py``:
the TI2V pipeline rides the same ``_split``, solver and ``dit_forward``) and
two of the image-to-video mode's own, registered in ``faults.FAULTS`` under
``ti2v`` when this module is imported: ``bench_h100/conftest.py`` imports it
for the tests; ``control.py --fault`` needs it imported before it runs."""

from __future__ import annotations

from faults import FAULTS


def _per_frame_t_dropped(patch):
    """Every token at the step's t: the conditioning frame's t = 0 dropped."""
    from wanq_tpu_torch.pipelines.text2video import WanT2V
    from wanq_tpu_torch.pipelines.textimage2video import WanTI2V

    patch(WanTI2V, "_timesteps", WanT2V._timesteps)


def _frame0_not_held(patch):
    """Frame 0 held before the first step only, not after a solver step."""
    from wanq_tpu_torch.pipelines.textimage2video import WanTI2V

    generate, hold = WanTI2V.generate, WanTI2V._held

    def generate_once(self, *args, **kw):
        self._holds = 0
        return generate(self, *args, **kw)

    def held_once(self, latents):
        self._holds = getattr(self, "_holds", 0) + 1
        return hold(self, latents) if self._holds == 1 else latents

    patch(WanTI2V, "generate", generate_once)
    patch(WanTI2V, "_held", held_once)


FAULTS.setdefault("ti2v", {**FAULTS["denoise"], "per_frame_t_dropped": _per_frame_t_dropped,
                           "frame0_not_held": _frame0_not_held})
