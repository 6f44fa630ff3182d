"""The real bytes of the persistent training state, float32 against packed
(``--packed_weights --packed_momentum``), on the port.

The counterpart of ``experiments/memory_footprint.py``, with its flags and
JSON keys, plus ``--device`` (default ``cuda``).  The reference only
simulates compression (quantize -> dequantize in float32), so its
processes never hold less; here both states are built on the device and
their tensor bytes summed: the parameters and the optimizer's buffers
(float32), against the packed parameters (uint8 codes and two float32
stats a leaf, the BatchNorm leaves float32) and packed momentum.  The
optimizer's step count is a host integer here (the JAX state holds an
int32 array: its totals are 4 bytes more).  On the card it reports
``torch.cuda.memory_allocated`` beside each sum.  ``--fsdp N`` adds the
bytes of one rank's blocks under an N-way FSDP layout
(``parallel/train_fsdp_q.py::FSDPLayout``, the packed state in its
``fsdp_size`` layout); ``--checkpoints`` the bytes on disk of each state
as the trainer saves it (``torch.save``) and of the float32 state as
``train/checkpoint.py`` archives it (bit-packed SmaQ):

  python -m smart_quantization_tpu_torch.experiments.memory_footprint \\
      --model resnet18 --opt adam --fsdp 4 --checkpoints
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch


def state_bytes(tree) -> int:
    """Bytes of every tensor in a state tree (dicts, ``SmaQCodes``,
    ``CompressedOptState``)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    if isinstance(tree, tuple):  # SmaQCodes, CompressedOptState
        return sum(state_bytes(v) for v in tree)
    return 0


def _allocated(device) -> int | None:
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet18", choices=["resnet18", "resnet34"])
    ap.add_argument("--opt", default="adam", choices=["sgd", "adam", "adamw"])
    ap.add_argument("--checkpoints", action="store_true",
                    help="also write the states to disk and compare their sizes")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="also report one rank's bytes under an N-way FSDP layout")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the result here as well")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from smart_quantization_tpu_torch import resolve_device
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.experiments import device_meta
    from smart_quantization_tpu_torch.models.resnet import resnet18, resnet34
    from smart_quantization_tpu_torch.optim.compressed import (
        OptimizerCompression,
        build_optimizer,
        encode_params,
        init_opt_state,
        norm_param_mask,
    )
    from smart_quantization_tpu_torch.parallel.train_fsdp_q import FSDPLayout

    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.manual_seed(0)
    model = {"resnet18": resnet18, "resnet34": resnet34}[args.model](num_classes=10)
    base = _allocated(device)
    params = {n: p.detach().to(device) for n, p in model.named_parameters()}
    del model
    spec = build_optimizer(args.opt, 0.1)
    smaq = build_compressor("smart")
    packed_comp = OptimizerCompression(compressor=smaq, packed_momentum=True, packed_weights=True)
    exempt = norm_param_mask(params)
    gen = torch.Generator().manual_seed(2)

    opt_fp32 = init_opt_state(spec, params, OptimizerCompression(compressor=smaq))
    fp32 = {"params": params, "opt": opt_fp32}
    bytes_fp32 = state_bytes(fp32)
    alloc_fp32 = _allocated(device)
    opt_packed = init_opt_state(spec, params, packed_comp, gen)
    params_packed = encode_params(params, packed_comp, gen, exempt=exempt)
    packed = {"params": params_packed, "opt": opt_packed}
    bytes_packed = state_bytes(packed)
    alloc_both = _allocated(device)

    out = {
        "experiment": "real_training_state_memory",
        "model": args.model,
        "optimizer": args.opt,
        "param_count": sum(p.numel() for p in params.values()),
        "fp32_state_bytes": bytes_fp32,
        "packed_state_bytes": bytes_packed,
        "reduction_x": round(bytes_fp32 / bytes_packed, 3),
        "step_count": "a host int (the JAX state: an int32 array, 4 bytes)",
        **device_meta(device),
    }
    if base is not None:
        out["cuda_allocated_fp32_state_bytes"] = alloc_fp32 - base
        out["cuda_allocated_packed_state_bytes"] = alloc_both - alloc_fp32

    if args.fsdp > 1:
        n = args.fsdp
        layout = FSDPLayout({k: tuple(p.shape) for k, p in params.items()}, n)
        fp32_shard = state_bytes(layout.local(params, 0)) + state_bytes(
            layout.local_opt_state(opt_fp32, 0))
        opt_packed_f = init_opt_state(spec, params, packed_comp, gen, fsdp_size=n)
        params_packed_f = encode_params(params, packed_comp, gen, exempt=exempt, fsdp_size=n)
        packed_shard = state_bytes(layout.local(params_packed_f, 0)) + state_bytes(
            layout.local_opt_state(opt_packed_f, 0))
        out.update({
            "fsdp": n,
            "fsdp_fp32_state_bytes_per_shard": fp32_shard,
            "fsdp_packed_state_bytes_per_shard": packed_shard,
            "fsdp_packed_reduction_x": round(fp32_shard / packed_shard, 3),
            "fsdp_total_reduction_vs_single_fp32_x": round(bytes_fp32 / packed_shard, 3),
        })

    if args.checkpoints:
        from smart_quantization_tpu_torch.train.checkpoint import save_compressed
        from smart_quantization_tpu_torch.train.state import to_saved

        with tempfile.TemporaryDirectory(prefix="smaq_ckpt_") as d:
            for name, tree in (("fp32", fp32), ("packed", packed)):
                path = os.path.join(d, f"{name}.pt")
                torch.save(to_saved(tree), path)
                out[f"ckpt_{name}_bytes"] = os.path.getsize(path)
            path = os.path.join(d, "archive.pt")
            save_compressed(path, fp32, torch.Generator().manual_seed(3))
            out["ckpt_compressed_archive_fp32_bytes"] = os.path.getsize(path)
        out["ckpt_reduction_x"] = round(out["ckpt_fp32_bytes"] / out["ckpt_packed_bytes"], 3)

    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
