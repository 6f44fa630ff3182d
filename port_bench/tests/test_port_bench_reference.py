"""The reference against the program at tiny sizes on the CPU (so the
oracle is trusted), the comparison failing on a bfloat16 stand-in for a
float32 cell, and, on the card only, the control and the faults that a
run must call incorrect."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import cell as cells
from port_bench import inputs
from port_bench.calibrate import HalfBatch
from port_bench.reference import bert, compare, philox
from port_bench.reference.optim import Hyper
from port_bench.reference.smaq import SmaQ, quantize
from port_bench.reference.step import Step
from port_bench.reference.train import follow
from port_bench.run import judge
from port_bench.tests.helpers import card, small_cell  # noqa: F401

SEED = 2**31 + 12345


def tiny_bert_cfg() -> dict:
    cfg = cells.load_json("configs", "bert-base-stsb.json")
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
               intermediate_size=128, max_position_embeddings=64)
    return cfg


def tiny_stsb() -> dict:
    return {"kind": "stsb", "pool_batches": 3, "length": 64, "sentence_tokens": [4, 20],
            "word_ids_from": 1000, "vocab": 30522, "label_range": [0.0, 5.0]}


@pytest.mark.parametrize("n,call", [(1, 0), (13, 7), (4096, 2**31 + 5), (1001, 123456)])
def test_philox_words_are_the_programs(n, call):
    from smart_quantization_tpu_torch.ops.cuda.philox_kernel import philox_fill_reference
    from smart_quantization_tpu_torch.ops.keys import key_tensor

    key = 0xF123456789ABCDEF
    words = philox_fill_reference(n, key_tensor(key, "cpu"), call, uniform=False)
    assert torch.equal(philox.words(n, key, call, "cpu"), words.to(torch.int64) & 0xFFFFFFFF)


@pytest.mark.parametrize("shape", [(5,), (300,), (64, 3, 3, 3), (40000,)])
def test_smaq_is_the_programs_plain_version(shape):
    """Each element within one grid step of the program's plain version of
    its kernels fed the same noise, and nearly every element equal (that
    version's pivot is torch's mean of the first 256 elements and its last
    multiply-add rounds twice: a rounding apart, which may move an element
    across a grid point)."""
    from smart_quantization_tpu_torch.ops.cuda.smaq_kernel import smaq_fused_reference
    from smart_quantization_tpu_torch.ops.smaq import SmaQParams

    gen = torch.Generator().manual_seed(7)
    x = (torch.randn(shape, generator=gen) * 3 + 1).float()
    n = x.numel()
    u = philox.uniform(n, 99, 4, "cpu")
    mine = quantize(x, lambda m: u, SmaQ())
    theirs, _ = smaq_fused_reference(x, None, SmaQParams(), u=u.view(shape))
    if n < SmaQ().min_size:
        assert torch.equal(mine, x)
        return
    step = float(x.std()) / SmaQ().range_main
    diff = (mine - theirs).abs()
    assert float(diff.max()) <= step * 1.001
    assert float((diff > 1e-5 * step).float().mean()) < 1e-2


def test_resnet_cell_follows_the_program_on_the_cpu():
    """The uncompressed ResNet-18 cell at batch 4: the program's first three
    steps and its next two groups of two read exactly the reference's."""
    c = small_cell("resnet18-nocompress-bf16-k8", 4, 2, "float32", pool_batches=8)
    args, trainer, state, pool, params0 = cells.build(c, SEED, "cpu")
    prog = cells.Driver(trainer, state, pool, c.k).check(params0, c.mix["check_steps"])
    ref = cells.reference(c, args, SEED, pool, "cpu")
    assert len(prog["losses"]) == len(ref["losses"]) == 7
    assert sorted(prog["updates"]) == sorted(ref["updates"]) == [3, 7]
    gaps = compare.gaps(prog, ref)
    assert gaps["loss_gap"] == gaps["grad_gap"] == gaps["update_gap"] == 0.0
    assert gaps["group_unmoved"] == 0.0
    correct, _ = judge(c, gaps, 0)
    assert correct


def test_bert_forward_and_backward_are_the_programs():
    """A two-layer BERT without dropout or compression: the program's
    logits, loss and every gradient against the reference's."""
    from smart_quantization_tpu_torch.inject.tap import TapContext
    from smart_quantization_tpu_torch.models.bert import BertConfig, BertForSequenceClassification

    cfg = tiny_bert_cfg()
    model = BertForSequenceClassification(
        BertConfig(vocab_size=cfg["vocab_size"], hidden_size=64, num_layers=2, num_heads=2,
                   intermediate_size=128, max_position_embeddings=64, dropout_rate=0.0),
        num_labels=1)
    params = inputs.weights(cfg, bert.param_shapes(cfg), SEED, "cpu")
    theirs = dict(model.named_parameters())
    assert [(k, tuple(v.shape)) for k, v in theirs.items()] == \
        [(k, tuple(v.shape)) for k, v in params.items()]
    with torch.no_grad():
        for k, p in theirs.items():
            p.copy_(params[k])
    x, y = inputs.Pool(tiny_stsb(), 2, SEED, "cpu")[0]
    model.train()
    loss = torch.mean((model(*(x[k] for k in bert.INPUT_KEYS), TapContext(None))[:, 0] - y) ** 2)
    loss.backward()
    cfg0 = dict(cfg, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ref = bert.loss(bert.forward(cfg0, leaves, x, Step(1, None, "cpu", "float32"),
                                 torch.float32), y)
    ref.backward()
    torch.testing.assert_close(loss, ref, rtol=1e-6, atol=0)
    for k, p in theirs.items():
        torch.testing.assert_close(p.grad, leaves[k].grad, rtol=1e-5, atol=1e-7)


def test_a_bf16_stand_in_fails_the_float32_cell():
    """Three AdamW steps of a two-layer BERT with SmaQ, the reference in
    bfloat16 standing in for the program of a float32 cell: the comparison
    calls it incorrect under the float32 cell's limits."""
    cfg = tiny_bert_cfg()
    mix = cells.load_json("mixes", "bert-base-smaq-f32-k4.json")
    params0 = inputs.weights(cfg, bert.param_shapes(cfg), SEED, "cpu")
    pool = inputs.Pool(tiny_stsb(), 4, SEED, "cpu")
    batches = [pool[i] for i in range(3)]
    hp = Hyper("adamw", 2e-5, weight_decay=0.01)

    def readings(dtype):
        out = follow(cfg, hp, SmaQ(), dtype, SEED, params0, batches, 3, dtype)
        return {"losses": out["losses"], "grad_norms": out["grad_norms"],
                "grad": compare.norms(out["first_buffer"]),
                "updates": {3: compare.norms(out["params"], params0)}}

    ref, stand_in = readings("float32"), readings("bfloat16")
    gaps = compare.gaps(stand_in, ref)
    assert any(gaps[k] > mix["limits"][k] for k in ("loss_gap", "grad_gap", "update_gap")), gaps


def _judged(c, seed, fault=None, precision=None) -> tuple[bool, dict]:
    """A run's check at a small size on the card: the program (with
    ``fault`` planted) or, with ``precision``, the control in its place."""
    args, trainer, state, pool, params0 = cells.build(c, seed, "cuda")
    if fault is not None:
        fault(trainer)
    prog = cells.Driver(trainer, state, pool, c.k).check(params0, c.mix["check_steps"])
    del trainer, state, params0
    cells.release()
    ref = cells.reference(c, args, seed, pool, "cuda")
    if precision is not None:
        prog = dict(cells.reference(c, args, seed, pool, "cuda", precision=precision),
                    moved=prog["moved"])
    gaps = compare.gaps(prog, ref)
    return judge(c, gaps, 0)


SMALL = {"resnet18-smaq-bf16-k8": (32, 2), "bert-base-smaq-f32-k4": (2, 2),
         "resnet18-nocompress-bf16-k8": (32, 2)}


def _half_batch(trainer):
    trainer.task = HalfBatch(trainer.task)


def _stale_replay(trainer):
    """Every replay of the K-step graph runs on the batches of the group it
    captured: the copy of a later group's batches into the graph's slots
    is left out (its keys still go in)."""
    from smart_quantization_tpu_torch.train import graph

    fill = graph.StepGraph._fill

    def stale(self, batches, aux_rows):
        if self.graph is None:
            return fill(self, batches, aux_rows)
        if aux_rows is not None:
            self.aux.copy_(graph.to_device(aux_rows, self.device), non_blocking=True)

    graph.StepGraph._fill = stale


def _state_unchanged(trainer):
    """The step returns the parameters and the optimizer state it got."""
    import smart_quantization_tpu_torch.train.loop as loop

    def unchanged(spec, params, grads, opt_state, *a, **k):
        return params, opt_state, {}

    loop.compressed_optimizer_step = unchanged


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_control_is_incorrect_on_the_card(card, name):  # noqa: F811
    c = small_cell(name, *SMALL[name])
    correct, checks = _judged(c, SEED, precision=c.mix["control_precision"])
    assert not correct, json.dumps(checks)


@pytest.mark.card
@pytest.mark.parametrize("fault", [_half_batch, _state_unchanged, _stale_replay])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_faults_are_incorrect_on_the_card(card, name, fault, monkeypatch):  # noqa: F811
    import smart_quantization_tpu_torch.train.loop as loop
    from smart_quantization_tpu_torch.train import graph

    monkeypatch.setattr(loop, "compressed_optimizer_step", loop.compressed_optimizer_step)
    monkeypatch.setattr(graph.StepGraph, "_fill", graph.StepGraph._fill)
    c = small_cell(name, *SMALL[name])
    correct, checks = _judged(c, SEED + 1, fault=fault)
    assert not correct, json.dumps(checks)
