"""chip_smoke.py off the card: it refuses to run without a GPU (and prints
no result line), the MSM program it checks on the card is integer
arithmetic only, and its phases' logic holds at tiny sizes."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """In the repo on the CPU, and as a lone copy of the script, the run
    exits non-zero and prints no ``ok`` line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    out = _run(cwd, str(script))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_msm_program_is_integer_only():
    sys.path.insert(0, REPO)
    import chip_smoke

    hlo = chip_smoke.msm_program_text()
    assert "i32" in hlo
    for bad in ("f16", "f32", "f64", "dot_general"):
        assert bad not in hlo


def test_smoke_sizes_are_the_flagship_circuits():
    """The full-width phases run the sizes their docstrings claim."""
    sys.path.insert(0, REPO)
    import chip_smoke
    from bulletproofs_r1cs_gadgets_tpu.gadgets.poseidon import PoseidonParams
    from bulletproofs_r1cs_gadgets_tpu.models.compiled import (
        CompiledVSMT2,
        CompiledVSMT4,
    )

    sizes = chip_smoke.Sizes()
    params = PoseidonParams(*sizes.hash_params)
    vsmt2 = CompiledVSMT2(params, sizes.full_depth, constrain_index_bits=False)
    assert vsmt2.num_multipliers == 143_704
    assert CompiledVSMT4(params, sizes.batch_depth).num_multipliers == 74_624
    eq = CompiledVSMT2(params, sizes.eq_depth, constrain_index_bits=False)
    assert eq.num_multipliers == 4_544


@pytest.mark.parametrize("phase", ["phase_msm", "phase_equivalence"])
def test_smoke_phase_rehearsal(phase, monkeypatch):
    """A phase's checks, run on the CPU at tiny sizes with small compiled
    shapes (the same code the card runs at full width)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "SIZES", chip_smoke.Sizes(
        msm_n=35, timing_log2=(5,), eq_depth=1, hash_params=(6, 1, 1, 1),
    ))
    monkeypatch.setattr(chip_smoke, "BACKEND_KW", dict(
        min_device_n=1, chunk=32, window=2, fold_chunk=16,
    ))
    chip_smoke.Phase.install()
    getattr(chip_smoke, phase)()
