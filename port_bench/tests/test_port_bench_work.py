"""The frozen work counts of ``work/<config>.py`` against the published
totals and against what the program's own taps and optimizer quantize in
a step on the CPU."""

from __future__ import annotations

import math
import os

import pytest

from port_bench import cell as cells
from port_bench.tests.helpers import small_cell

# the elements a step's SmaQ calls take (the program's taps and optimizer
# at the cells' batches: ResNet-18 at 128 images, bert-base at 32 x 512)
PUBLISHED_ELEMENTS = {"resnet18-cifar10": (128, 553_742_174), "bert-base-stsb": (32, 3_785_035_844)}
PARAMS = {"resnet18-cifar10": 11_173_962, "bert-base-stsb": 109_483_009}


def work_of(config: str):
    return cells.load_module(os.path.join(cells.ROOT, "work", f"{config}.py"), "port_bench_work")


def elements(config: str, batch: int, chips: int = 1, compress: bool = True,
             dtype: str = "float32") -> dict:
    cfg = cells.load_json("configs", f"{config}.json")
    mix = {"compress": compress, "batch": batch, "chips": chips, "compute_dtype": dtype}
    return {s: (n, dt, p) for s, n, dt, p in work_of(config).compression(cfg, mix)}


@pytest.mark.parametrize("config", sorted(PUBLISHED_ELEMENTS))
def test_totals_are_the_published_ones(config):
    batch, total = PUBLISHED_ELEMENTS[config]
    got = elements(config, batch)
    assert sum(n for s, (n, _, _) in got.items() if s != "dropout_words") == total
    assert got["gradients"][0] == PARAMS[config]


def test_resnet18_forward_is_0555_gmac():
    cfg = cells.load_json("configs", "resnet18-cifar10.json")
    macs = work_of("resnet18-cifar10").flops_per_sample(cfg) / 6
    assert macs == 555_422_720


def test_bert_base_step_is_about_9_3_tflop():
    cfg = cells.load_json("configs", "bert-base-stsb.json")
    flops = work_of("bert-base-stsb").flops_per_sample(cfg) * 32
    assert 9.2e12 < flops < 9.4e12


def test_element_types_follow_the_compute_dtype():
    got = elements("resnet18-cifar10", 128, dtype="bfloat16")
    assert got["forward_maps"][1] == got["gradient_maps"][1] == "bfloat16"
    assert {got[s][1] for s in ("gradients", "weights", "momentum")} == {"float32"}
    assert elements("resnet18-cifar10", 128, compress=False) == {}
    assert elements("resnet18-cifar10", 512, chips=4) == elements("resnet18-cifar10", 128)


def _observed(name: str, batch: int) -> tuple[dict, int]:
    """Elements of the program's SmaQ calls in one CPU step at ``batch``,
    by where they were made (the taps, the optimizer), and the elements of
    its dropout noise."""
    import smart_quantization_tpu_torch.compress.encoders as enc
    import smart_quantization_tpu_torch.models.bert as mbert
    import smart_quantization_tpu_torch.train.loop as loop

    c = small_cell(name, batch, 1, "float32", pool_batches=1)
    counts = {"taps": 0, "optimizer": 0}
    where = ["taps"]
    dropout = [0]
    orig_call, orig_step, orig_uniform = (enc.SmaQ.__call__, loop.compressed_optimizer_step,
                                          mbert.uniform)

    def call(self, x, gen, **kw):
        counts[where[0]] += x.numel()
        return orig_call(self, x, gen, **kw)

    def step(*a, **k):
        where[0] = "optimizer"
        return orig_step(*a, **k)

    def uniform(shape, gen, device):
        dropout[0] += math.prod(shape)
        return orig_uniform(shape, gen, device)

    enc.SmaQ.__call__, mbert.uniform, loop.compressed_optimizer_step = call, uniform, step
    try:
        args, trainer, state, pool, _ = cells.build(c, 3, "cpu")
        trainer.train_step(state, *trainer.prepare_batch(*pool[0]))
    finally:
        enc.SmaQ.__call__, mbert.uniform = orig_call, orig_uniform
        loop.compressed_optimizer_step = orig_step
    return counts, dropout[0]


@pytest.mark.parametrize("name,config,batch", [
    ("resnet18-smaq-bf16-k8", "resnet18-cifar10", 2),
    ("bert-base-smaq-f32-k4", "bert-base-stsb", 1),
])
def test_counts_are_what_the_program_quantizes(name, config, batch):
    """One step of the program at a small batch on the CPU: its taps'
    elements, scaled to the cell's batch, its optimizer's and its dropout
    noise's are the work module's."""
    counts, dropout = _observed(name, batch)
    full_batch = PUBLISHED_ELEMENTS[config][0]
    want = elements(config, full_batch)
    assert counts["taps"] * full_batch // batch == want["forward_maps"][0] * 2
    opt_elements = sum(want[s][0] for s in ("gradients", "weights", "momentum"))
    assert counts["optimizer"] == opt_elements
    if "dropout_words" in want:
        assert dropout * full_batch // batch == want["dropout_words"][0]
