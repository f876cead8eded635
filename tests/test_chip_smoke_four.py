"""chip_smoke.py's four-card phase on four virtual CPU devices: the
single-device cascade, per-shard engines on their own devices and the
(data x shard) mesh program give byte-identical reports."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY4 = chip_smoke.World(
    nt_shards=((1, 80_000),) * 4,
    host=(0, 0),
    pairs=200,
    shard_frac=(0.25,) * 4,
    host_frac=0.0,
    readthrough_frac=0.0,
    cpu_pairs=0,
)


def test_four_card_cascades_agree(tmp_path, capsys):
    chip_smoke.phase_four_cards(
        world=TINY4, workdir=str(tmp_path / "four"), seed=2, card="cpu"
    )
    assert "byte-identical" in capsys.readouterr().out
