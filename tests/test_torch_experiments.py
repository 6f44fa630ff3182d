"""The port's experiment drivers (``smart_quantization_tpu_torch/
experiments/``) at a tiny size on the CPU: the encoder sweep (TinyCNN) and
the BERT sweep (the tiny config), one epoch of two batches under fp32 and
SmaQ, and the repeated-application drift.  Each result file has the keys
of the JAX drivers' committed TPU files (``experiments/results/``): the
same entry keys, and every ``_meta`` key (the port adds where it ran:
``card`` and ``power_limit``)."""

import json
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tpu_keys(name: str) -> tuple[set, set]:
    """(entry keys, ``_meta`` keys) of a committed TPU result file."""
    with open(os.path.join(ROOT, "experiments", "results", name)) as f:
        d = json.load(f)
    entries = [v for k, v in d.items() if not k.startswith("_")]
    assert all(set(e) == set(entries[0]) for e in entries)
    return set(entries[0]), set(d["_meta"])


def check_result(results: dict, tpu_file: str, encoders=("fp32", "smart")) -> None:
    entry_keys, meta_keys = tpu_keys(tpu_file)
    assert set(results) == {"_meta", *encoders}
    assert meta_keys <= set(results["_meta"])
    assert results["_meta"]["backend"] == "cpu"
    for enc in encoders:
        assert set(results[enc]) == entry_keys, enc
        assert not results[enc]["nan_terminated"]
        assert len(results[enc]["history"]) == 1
    assert results["fp32"]["compression_ratio"] == 1.0
    assert 4.5 <= results["smart"]["compression_ratio"] <= 5.5


def test_encoder_sweep_writes_the_tpu_keys(tmp_path, monkeypatch):
    from smart_quantization_tpu_torch.experiments import encoder_sweep

    monkeypatch.setenv("SMAQ_SYNTH_TRAIN_N", "256")
    monkeypatch.setenv("SMAQ_SYNTH_TEST_N", "64")
    out = tmp_path / "sweep.json"
    results = encoder_sweep.main([
        "--device", "cpu", "--model", "tiny", "--epochs", "1", "--limit_train_batches", "2",
        "--batch_size", "32", "--encoders", "fp32", "smart", "--out", str(out)])
    check_result(results, "encoder_sweep_resnet34_synthetic.json")
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert 0.0 <= results["smart"]["val_accuracy"] <= 1.0


def test_bert_sweep_writes_the_tpu_keys(tmp_path):
    from smart_quantization_tpu_torch.experiments import bert_sweep

    out = tmp_path / "bert.json"
    results = bert_sweep.main([
        "--device", "cpu", "--epochs", "1", "--batch_size", "32", "--val_batch_size", "32",
        "--train_n", "64", "--val_n", "32", "--max_input_length", "16",
        "--steps_per_call", "1", "--encoders", "fp32", "smart", "--out", str(out)])
    check_result(results, "bert_sweep_stsb_synthetic.json")
    assert np.isfinite(results["smart"]["mean_correlation"])


def test_bert_sweep_encoder_specs():
    from smart_quantization_tpu_torch.experiments.bert_sweep import parse_encoder_spec

    base, cov = parse_encoder_spec("smart@rowlognu,nofwd")
    assert base == "smart" and cov["log_nu"] and cov["log_nu_rowwise"]
    assert not cov["compress_forward"] and cov["compress_backward"]
    assert parse_encoder_spec("fp8")[1]["compress_momentum"]
    with pytest.raises(ValueError, match="unknown ablation token"):
        parse_encoder_spec("smart@nope")


def test_bias_drift_is_unbiased(capsys):
    """SmaQ with stochastic rounding, 50 in-place applications: the mean
    drift stays near zero (tests/test_smaq.py:65-77 takes 0.02)."""
    from smart_quantization_tpu_torch.experiments import bias_drift

    drift = bias_drift.main(["--device", "cpu", "--repeats", "50", "--trials", "2"])
    assert abs(drift) < 0.02
    out = capsys.readouterr().out
    assert "final-drift histogram" in out and "OVERALL mean drift after 50 applications" in out
