"""chip_smoke.py's phases at tiny sizes on CPU, and its card-free helpers.

The script runs on the GPU at real sizes; these tests call the same phase
functions small, so a wrong path, argument or tolerance shows here first.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

from fastoptsolver_tpu.bench import device as devmod  # noqa: E402

SMI = "NVIDIA H100 80GB HBM3, 700.00 W\n"


def _assert_records(records, names):
    assert [r["phase"] for r in records] == names
    for r in records:
        assert r["compile_s"] >= 0.0 and r["run_s"] > 0.0
        assert r["max_err"] <= r["tol"] or r["phase"] == "headline_batch"
        assert r["tol_reason"]
        json.dumps(r, default=str)  # one JSON line per phase


def test_phase_precision_tiny():
    _assert_records(chip_smoke.phase_precision(64), ["precision"])


def test_phase_df32_tiny():
    (rec,) = chip_smoke.phase_df32(257)
    assert rec["two_sum_err"] == 0.0 and rec["mul_err"] == 0.0


def test_phase_headline_batch_tiny():
    (rec,) = chip_smoke.phase_headline_batch(256, 200, n_sample=16,
                                             n_oracle=2)
    assert rec["converged"] == 256
    assert rec["oracle_err_over_bound"] <= 1.0
    assert rec["max_err"] <= rec["tol"] + 1e-5


def test_phase_wide_n_batch_tiny():
    (rec,) = chip_smoke.phase_wide_n_batch(16, 16 * 16 * 4 * 24, n_sample=8)
    assert rec["batch"] == 24 and rec["converged"] == 24


def test_phase_cv_grid_tiny():
    (rec,) = chip_smoke.phase_cv_grid(120, 8, n_sample=12, n_alphas=10)
    assert rec["grid_instances"] == 60


def test_phase_dense_and_stream_tiny():
    recs = chip_smoke.phase_dense_and_stream(2048, 32, 300, 4096, 24, 1024)
    _assert_records(recs, ["dense_and_stream/dense", "dense_and_stream/stream"])


def test_phase_resume_tiny():
    (rec,) = chip_smoke.phase_resume(256, 200, cut_iter=25)
    assert rec["bit_exact"]


def test_phase_mesh_batch_four_virtual_devices():
    recs = chip_smoke.phase_mesh_batch(64, 200, jax.devices()[:4],
                                       n_sample=16)
    _assert_records(recs, ["mesh_instance_parallel", "mesh_resume"])
    assert recs[1]["bit_exact"]


def test_phase_mesh_dense_four_virtual_devices():
    recs = chip_smoke.phase_mesh_dense(256, 16, 200, jax.devices()[:4],
                                       admm_iters=500)
    _assert_records(recs, ["mesh_row_sharded", "mesh_col_sharded",
                           "mesh_consensus_admm"])


@pytest.mark.parametrize("four_cards,names", [
    (False, ["precision", "df32", "resume", "headline_batch", "wide_n_batch",
             "cv_grid", "dense_and_stream"]),
    (True, ["mesh_batch", "mesh_dense"]),
])
def test_phase_selection(four_cards, names):
    mode = chip_smoke.FOUR_CARDS if four_cards else chip_smoke.ONE_CARD
    assert [name for name, _ in chip_smoke.phases(mode, [])] == names


def test_last_line_format():
    line = chip_smoke.last_line(
        {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}')


def test_main_refuses_a_cpu_device(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([], smi_query=lambda: SMI)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == SMI.strip()
    assert '"ok"' not in out


def test_main_refuses_without_nvidia_smi(capsys):
    def missing():
        raise RuntimeError("nvidia-smi found no NVIDIA card")

    with pytest.raises(RuntimeError, match="nvidia-smi"):
        chip_smoke.main(["--four-cards"], smi_query=missing)
    assert '"ok"' not in capsys.readouterr().out


def test_parse_nvidia_smi_fixed_output():
    text = "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 650.00 W"
    assert devmod.parse_nvidia_smi(text) == [
        {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"},
        {"name": "NVIDIA H100 80GB HBM3", "power_limit": "650.00 W"},
    ]
    for bad in ("", "no comma here"):
        with pytest.raises(ValueError):
            devmod.parse_nvidia_smi(bad)


def test_peaks_known_and_unknown_kind():
    row = devmod.peaks_for("NVIDIA H100 80GB HBM3")
    assert row["hbm_bytes_per_s"] == 3.35e12 and row["source"]
    with pytest.raises(ValueError, match="no published peaks"):
        devmod.peaks_for("cpu")


def test_require_gpu_rejects_cpu_devices():
    with pytest.raises(RuntimeError, match="no GPU"):
        devmod.require_gpu(jax.devices())
