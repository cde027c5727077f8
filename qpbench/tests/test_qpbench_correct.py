"""What decides `correct`: a whole run at a tiny size on the CPU, with the
timed path broken underneath by each fault the cell can have
(qpbench/faults.py), comes out not correct (against the limits set at that
size, `tiny.py`); the control, put through the run's own checks in the
program's place, reads far above the program and comes out not correct;
and on the card the control at the cell's own size comes out not correct
against the committed limits."""

import pytest
import torch

from qpbench import control, faults
from qpbench.tests import tiny

KIND = {"default.decode.b20": "decode", "rd10.decode.w8a8.b7": "decode",
        "default.train.f32": "train", "default.serve.c32": "serve"}
SECONDS = {"default.serve.c32": 2.0}
CASES = [(c, f) for c in tiny.CELLS for f in faults.KINDS[KIND[c]]]


def small(name):
    return dict(cfg_override=tiny.TINY, traffic_override=tiny.SMALL[name])


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    run = tiny.run(name, seconds=SECONDS.get(name, 0.5))
    assert run.correct, {k: (c.value, c.limit) for k, c in run.checks.items()}
    assert run.attempted > 0 and run.failed == 0


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    out, run = control.readings(name, 31, SECONDS.get(name, 0.5),
                                torch.device("cpu"), fault, chunk_frames=2,
                                **small(name))
    assert not run.correct, out


@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_reads_far_above_the_program(name):
    out, run = control.readings(name, 37, SECONDS.get(name, 0.5),
                                torch.device("cpu"), None, **small(name))
    if KIND[name] == "train":
        assert out["control"]["grad_gap"] > 3 * out["checks"]["grad_gap"]
    else:
        assert out["control_logit_gap"] > 3 * out["checks"][
            "greedy_logit_gap"]
    assert run.correct
    assert not control.control_run(run).correct, out


@pytest.mark.card
@pytest.mark.parametrize("name", tiny.CELLS)
def test_control_fails_its_limit_on_the_card(card, name):
    """The control at the cell's own size, through the cell's checks in the
    program's place, comes out not correct."""
    out, run = control.readings(name, 2 ** 31 + 5, 10.0, card)
    assert out["control_correct"] is False, out
