"""On the card: the control fails the cells' limits, a sound run passes them.

    python3 -m pytest -p no:cacheprovider perfbench/tests/test_perfbench_cuda.py

The control is the reference with its products in TF32, put in the
program's place, and the planted faults of ``perfbench.tools.calibrate``;
here at a size a test run holds (100 lanes; 4096 paths).
``perfbench.tools.calibrate`` reads the same at the cells' own sizes.
"""
import pytest
import torch

from perfbench import run
from perfbench.tools.calibrate import faults
from perfbench.trace import Tracer

pytestmark = pytest.mark.cuda
SMALL = {"lv_study.adam": {"cfg": {"runs_per_level": 20}},
         "lv_study.bfgs": {"cfg": {"runs_per_level": 20}},
         "hjb100d.m131072": {"traffic": {"trajectories": 4096}}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_and_sound_run_passes(card, cell):
    c = run.Cell(cell)
    for key, extra in SMALL[cell].items():
        getattr(c, key).update(extra)
    mod = __import__(f"perfbench.drivers.{c.traffic['driver']}", fromlist=["Driver"])
    drv = mod.Driver(c.cfg, c.traffic, 2**32 + 101, card, Tracer(False))
    drv.setup()
    drv.collect()
    ref = drv.reference()
    sound = mod.readings(drv.first, ref)
    assert all(sound[k] <= lim for k, lim in c.limits.items()), sound
    for name, (rec, rec_ref) in faults(drv, ref).items():
        got = mod.readings(rec, rec_ref)
        assert any(got.get(k, 0) > lim for k, lim in c.limits.items()), (name, got)
