"""A run with its timed path broken underneath comes out not correct:
for each fault that a cell can have, on the CPU at tiny widths, with the
cells' own limits (workloads/<cell>.json). One chip: no exchange between
chips to leave out. And the control, the reference in float8 put in the
program's place, fails the limits too."""
import pytest
import torch

from benchmark.reference.numerics import Numerics
from benchmark.tests.runs import SERVING, cpu_run


def unchanged_state(monkeypatch):
    """Every DDIM step returns the sample it was given."""
    from storygen_tpu_torch.diffusion import schedule
    monkeypatch.setattr(schedule, "ddim_step",
                        lambda sched, eps, t, prev, sample, **kw: sample)


def half_batch(monkeypatch):
    """The second half of the batch is left out: its rows get the first
    half's latents."""
    from storygen_tpu_torch.pipeline import StoryGenSampler
    sample = StoryGenSampler.sample

    def broken(self, latents, *a, **kw):
        out = sample(self, latents, *a, **kw)
        h = out.shape[0] // 2
        return torch.cat([out[:out.shape[0] - h], out[:h]])
    monkeypatch.setattr(StoryGenSampler, "sample", broken)


def altered_answer(monkeypatch):
    """Each story gets its neighbour's decoded frame."""
    from storygen_tpu_torch.pipeline import StoryGenSampler
    decode = StoryGenSampler.decode
    monkeypatch.setattr(StoryGenSampler, "decode",
                        lambda self, z: decode(self, z).roll(1, dims=0))


def untrained(monkeypatch):
    """The optimizer keeps its state: no accumulation, no update."""
    from storygen_tpu_torch.training import optim
    monkeypatch.setattr(optim.AdamW, "update", lambda self, grads: False)


def flipped_update(monkeypatch):
    """The update moves each parameter the other way."""
    from storygen_tpu_torch.training import optim
    move = optim.AdamW._move

    def broken(self, p, mu, nu, lr, c1, c2):
        move(self, p, mu, nu, -lr, c1, c2)
    monkeypatch.setattr(optim.AdamW, "_move", broken)


def first_gradient_only(monkeypatch):
    """The update is made from the first micro-step's gradient: the later
    ones are not accumulated."""
    from storygen_tpu_torch.training import optim
    update = optim.AdamW.update

    def broken(self, grads):
        if self.mini_step:
            grads = {n: self.acc[n].clone() for n in grads}
        return update(self, grads)
    monkeypatch.setattr(optim.AdamW, "update", broken)


def half_loss(monkeypatch):
    """The loss's mean is taken over the first half of the batch."""
    from storygen_tpu_torch.training import steps
    mse = steps.masked_mse

    def broken(pred, target, mask=None):
        h = pred.shape[0] // 2
        return mse(pred[:h], target[:h], None if mask is None else mask[:h])
    monkeypatch.setattr(steps, "masked_mse", broken)


FAULTS = [(cell, f) for cell in SERVING
          for f in (unchanged_state, half_batch, altered_answer)]
FAULTS += [("train-stage2-b12", f) for f in (untrained, flipped_update, first_gradient_only,
                                        half_loss)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = cpu_run(cell).run()
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", SERVING + ["train-stage2-b12"])
def test_the_sound_run_is_correct(cell):
    line = cpu_run(cell).run()
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell", SERVING + ["train-stage2-b12"])
def test_the_control_is_not_correct(cell):
    """The reference in float8 in the program's place fails a limit."""
    run = cpu_run(cell)
    run.run()
    limits = run.bench.limits(cell)
    read = run.kind.readings(Numerics("fp8"))["control"]
    assert any(v > limits[n] for n, v in read.items()), read
