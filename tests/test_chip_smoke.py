"""chip_smoke.py on the CPU: its device guard, and its main-path phase
at a tiny size (the rehearsal of the GPU run)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = chip_smoke.World(
    nt_shards=((4, 60_000), (2, 20_000)),
    host=(2, 50_000),
    pairs=600,
    cpu_pairs=100,
)


def test_import_touches_no_device():
    code = ("import sys; import chip_smoke; "
            "print('jax' in sys.modules)")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, check=True,
        capture_output=True, text=True, timeout=120,
    )
    assert out.stdout.strip() == "False"


def test_refuses_cpu_backend(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "GPU device" in str(e.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_main_path_tiny(tmp_path, capsys):
    state = chip_smoke.phase_main(
        world=TINY, workdir=str(tmp_path / "smoke"), seed=3, card="cpu"
    )
    out = capsys.readouterr().out
    assert "[main] report:" in out
    assert "byte-identical" in out
    engine, args = state["nt_pass"]
    assert len(engine.ref.codes) == 4 * 60_000
    chip_smoke.phase_deep_dp_share(state["nt_pass"], "cpu", reps=1)
    assert "[deep-dp]" in capsys.readouterr().out
