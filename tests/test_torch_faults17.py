"""The unsteady driver test of the recovery suite, on the CPU.

``test_ex1_driver_rolls_back_plateaus_and_resumes_on_the_cpu`` runs the
ex1 driver twice, the second time with ``--resume-epoch``.  A checkpoint's
name ends in today's date in both packages (``utils/naming.py``), so when
the date turned between the two runs the second looked for another file,
started afresh, and the test failed on "resumed params + optimizer state".
The packages keep that naming; the recovery suite now runs on one date.
"""
import datetime

from galerkin_transformer_tpu.utils import naming as j_naming
from galerkin_transformer_torch.utils import naming
from tests import test_torch_recovery as recovery


class _Midnight(datetime.date):
    """A ``date`` whose ``today()`` is 2026-10-17 at its first call and
    2026-10-18 after it."""
    calls = 0

    @classmethod
    def today(cls):
        cls.calls += 1
        return cls(2026, 10, 17) if cls.calls == 1 else cls(2026, 10, 18)


def test_checkpoint_names_carry_the_date_in_both_packages(monkeypatch):
    for module in (naming, j_naming):
        monkeypatch.setattr(_Midnight, "calls", 0)
        monkeypatch.setattr(module, "date", _Midnight)
        before, after = module.get_model_name(), module.get_model_name()
        assert before[0].endswith("_2026-10-17.ckpt") and after[0].endswith("_2026-10-18.ckpt")


def test_ex1_resume_holds_when_the_date_turns_between_the_runs(tmp_path, monkeypatch, capsys):
    """The recovery suite's resume test under a clock that passes midnight
    between the two driver runs: it fails unless the suite pins the date."""
    monkeypatch.setattr(_Midnight, "calls", 0)
    monkeypatch.setattr(naming, "date", _Midnight)
    monkeypatch.setattr(j_naming, "date", _Midnight)
    recovery.pin_checkpoint_date(monkeypatch)
    recovery.test_ex1_driver_rolls_back_plateaus_and_resumes_on_the_cpu(tmp_path, monkeypatch,
                                                                        capsys)
