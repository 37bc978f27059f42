"""Faults planted under the program's timed path, to show that the check
catches them: the benchmark's tests plant each on the CPU, and
``control.py --fault <name>`` on the chip at a cell's own size. The
benchmark's own runs never plant one. ``plant(name, patch)`` replaces one
function of the program through ``patch(owner, attribute, value)`` (pytest's
``monkeypatch.setattr``, or :class:`Patches`)."""

from __future__ import annotations


def _state_unchanged_solver(patch):
    """A solver step that returns its state unchanged."""
    from wanq_tpu_torch.solvers import unipc

    patch(unipc.FlowUniPCMultistepScheduler, "step",
          lambda self, model_output, timestep, sample: sample)


def _half_batch(patch):
    """Half of the CFG batch left out: the conditional half stands for both."""
    from wanq_tpu_torch.pipelines.text2video import WanT2V

    def split(self, latents, t, context, context_null, ctx, seq_len, sequential=False,
              extra=None):
        cond = self._cond(latents, t, context, ctx, seq_len, extra)
        return cond, cond

    patch(WanT2V, "_split", split)


def _answer_altered(patch):
    """Each forward's answer altered where it is produced: one latent frame
    moved by its own standard deviation."""
    from wanq_tpu_torch.pipelines import text2video

    forward = text2video.dit_forward

    def altered(*args, **kw):
        out = forward(*args, **kw).clone()
        out[:, :, 0] += out[:, :, 0].std()
        return out

    patch(text2video, "dit_forward", altered)


def _state_unchanged_optimizer(patch):
    """An optimizer step that leaves the trained state unchanged."""
    import torch

    patch(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _distill_loss(patch, change):
    import torch

    from wanq_tpu_torch.training import distill

    def loss(student, teacher, g):
        with torch.no_grad():
            tcond, tuncond = teacher()
            target = tuncond + g * (tcond - tuncond)
        return change(student(), target)

    patch(distill, "_distill_loss", loss)


def _target_altered(patch):
    """The teacher's answer altered where it is produced: one latent frame of
    its CFG velocity moved by its own standard deviation."""
    import torch

    def change(s, t):
        t = t.clone()
        t[:, :, 0] += t[:, :, 0].std()
        return torch.mean(torch.square(s - t))

    _distill_loss(patch, change)


def _half_tokens(patch):
    """Half of the batch left out, the mean taken over the rest: one sequence
    a step, so the loss's mean over the first half of its latent frames."""
    import torch

    def change(s, t):
        half = s.shape[2] // 2
        return torch.mean(torch.square(s - t)[:, :, :half])

    _distill_loss(patch, change)


# the faults each job kind can have
FAULTS = {
    "denoise": {"state_unchanged": _state_unchanged_solver, "half_batch": _half_batch,
                "answer_altered": _answer_altered},
    "qlora": {"state_unchanged": _state_unchanged_optimizer, "answer_altered": _target_altered,
              "half_tokens": _half_tokens},
}


class Patches:
    """``patch(owner, attribute, value)`` that :meth:`undo` reverts."""

    def __init__(self):
        self.saved = []

    def __call__(self, owner, name, value):
        self.saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self.saved:
            owner, name, value = self.saved.pop()
            setattr(owner, name, value)


def plant(job_kind: str, name: str, patch) -> None:
    FAULTS[job_kind][name](patch)
