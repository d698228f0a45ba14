"""``tools/scaling_bench.py`` on the CPU: gloo ranks at world 1 and 2 for one
epoch on a few hundred points, and the refusal of more ranks than cards."""

import json

import numpy as np
import pytest

from collision_handling_in_instantngp_tpu_torch.tools import scaling_bench


def test_world_1_and_2_on_gloo(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    rows = scaling_bench.main(["--device", "cpu", "--world", "1", "2", "--epochs", "1",
                               "--pixels", "384", "--json-out", str(out)])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [r["devices"] for r in printed] == [1, 2]
    assert printed[0]["efficiency_vs_linear"] == 1.0
    for r, p in zip(rows, printed):
        assert p == {k: r[k] for k in p}
        assert np.isfinite(r["pixels_per_s"]) and r["pixels_per_s"] > 0
        assert len(r["epoch_s"]) == 1 and r["mesh"] == [r["devices"], 1]
        assert all(np.isfinite(v) for v in r["loss"])
    assert rows[1]["efficiency_vs_linear"] == pytest.approx(
        rows[1]["pixels_per_s"] / (2 * rows[0]["pixels_per_s"]))
    with open(out) as fh:
        assert json.load(fh)["rows"] == json.loads(json.dumps(rows))


def test_scaled_mesh_shards_tables_on_even_worlds():
    assert scaling_bench.model_parallel("scaled", 2) == 2
    assert scaling_bench.model_parallel("scaled", 1) == 1
    assert scaling_bench.model_parallel("gngf", 4) == 1
    assert scaling_bench.experiment("scaled").model.hash_table_size == 2 ** 14
    data = scaling_bench.random_points(300)
    assert data.num_pixels == 300 and data.image.shape == (300, 1, 3)


def test_more_ranks_than_cards_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(scaling_bench.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards"):
        scaling_bench.run_world(2, "gngf", 300, 1, "cuda", str(tmp_path))
