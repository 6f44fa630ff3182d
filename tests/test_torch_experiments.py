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


def test_memory_footprint_matches_the_jax_figures():
    """ResNet-18 with Adam: the parameter count and the float32, packed and
    per-shard (fsdp 8) state bytes of the JAX driver's committed file,
    less its step counter: the JAX state holds the count as an int32
    array (4 bytes, replicated on every shard), the port's is a host
    integer."""
    from smart_quantization_tpu_torch.experiments import memory_footprint

    with open(os.path.join(ROOT, "experiments", "results",
                           "memory_footprint_resnet18_adam.json")) as f:
        want = json.load(f)
    got = memory_footprint.main(["--device", "cpu", "--model", "resnet18", "--opt", "adam",
                                 "--fsdp", "8"])
    count_bytes = 4  # the JAX step counter, int32
    assert got["param_count"] == want["param_count"] == 11_173_962
    for key in ("fp32_state_bytes", "packed_state_bytes", "fsdp_fp32_state_bytes_per_shard",
                "fsdp_packed_state_bytes_per_shard"):
        assert got[key] == want[key] - count_bytes, key
    assert got["backend"] == "cpu" and got["fsdp"] == want["fsdp"] == 8


def test_bdi_throughput_writes_the_tpu_keys(tmp_path):
    from smart_quantization_tpu_torch.experiments import bdi_throughput

    out = tmp_path / "bdi.json"
    got = bdi_throughput.main(["--device", "cpu", "--big_n", "4096", "--reps", "3",
                               "--out", str(out)])
    with open(os.path.join(ROOT, "experiments", "results", "bdi_throughput.json")) as f:
        want = json.load(f)
    def by_threads(d):  # 1 thread and every core (2 on the TPU host)
        cores = d["_meta"]["hardware_concurrency"]
        return {k.replace(f"_t{cores}", "_tall") if cores > 1 else k for k in d}

    assert by_threads(got) <= by_threads(want) and "big_uniform_t1" in got
    for k in ("ref_shape_256_quantized", "big_uniform_t1"):
        assert set(got[k]) == set(want[k])
    assert got["ref_shape_256_quantized"]["compress_us"] > 0
    assert set(want["_meta"]) - {"thread_scaling_quantized"} <= set(got["_meta"])
    assert got["_meta"]["backend"] == "cpu"
    assert json.loads(out.read_text()) == got


def test_scratch_boundary_drives_the_bert_sweep(tmp_path):
    """Two warm-up lengths of a 2-epoch budget on the tiny config: the
    JAX driver's keys, warm-up 0 without a warm-up correlation."""
    from smart_quantization_tpu_torch.experiments import scratch_boundary

    out = tmp_path / "boundary.json"
    got = scratch_boundary.main([
        "--device", "cpu", "--warmups", "0", "1", "--total_epochs", "2", "--out", str(out),
        "--encoders", "fp32", "smart@rowmom,lognu", "--batch_size", "32", "--val_batch_size",
        "32", "--train_n", "32", "--val_n", "32", "--max_input_length", "16",
        "--steps_per_call", "1"])
    with open(os.path.join(ROOT, "experiments", "results", "bert_scratch_boundary.json")) as f:
        want = json.load(f)
    assert set(got) == {"_meta", "warmup0", "warmup1"}
    assert set(want["_meta"]) - {"conclusion"} <= set(got["_meta"])
    assert set(got["warmup0"]) == set(want["warmup0"])
    assert set(got["warmup1"]) == set(want["warmup0"]) | {"warmup_final_corr"}
    for w in ("warmup0", "warmup1"):
        for enc in ("fp32", "smart@rowmom,lognu"):
            assert set(got[w][enc]) == set(want["warmup0"][enc])
    assert 4.5 <= got["warmup1"]["smart@rowmom,lognu"]["compression_ratio"] <= 5.5
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))


def test_bert_nan_probe_reports_drift_and_adam_extrema(capsys):
    from smart_quantization_tpu_torch.experiments import bert_nan_probe

    got = bert_nan_probe.main(["--device", "cpu", "--fp32_warmup_epochs", "1", "--epochs", "1",
                               "--train_n", "32", "--val_n", "32", "--batch_size", "32",
                               "--max_input_length", "16", "--top_k", "3", "--skip_nu"])
    assert len(got["top_drift"]) == 3 and len(got["finetune_history"]) == 1
    assert got["top_drift"][0]["abs"] >= got["top_drift"][-1]["abs"] > 0
    assert got["params_finite"] and not got["nan_terminated"]
    assert got["max_abs_mu"] > 0 and got["max_nu"] > 0
    out = capsys.readouterr().out
    assert "top leaf drift" in out and json.loads(out.strip().splitlines()[-1]) == got


def test_summarize_sweeps_labels_each_source(capsys):
    """Both trees' sweeps, each headed by the package that wrote it and its
    backend; the port's H100 file names its card."""
    from smart_quantization_tpu_torch.experiments import summarize_sweeps

    got = {s["file"]: s for s in summarize_sweeps.main([])}
    port = got["encoder_sweep_resnet18_synthetic_h100.json"]
    assert port["source"].startswith("PyTorch port, NVIDIA H100")
    assert got["encoder_sweep_resnet18_synthetic.json"]["source"] == "JAX package, tpu"
    assert {r[0] for r in port["rows"]} >= {"fp32", "smart", "fp8"}
    assert "[PyTorch port, NVIDIA H100" in capsys.readouterr().out


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh process (two threads,
    beside the suite's workers): neither ``jax`` nor
    ``smart_quantization_tpu`` is loaded."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import smart_quantization_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or\n"
        "             m == 'smart_quantization_tpu' or m.startswith('smart_quantization_tpu.'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) > 60 and bad == "[]", out.stdout
