"""Repeated-application bias/drift on the port.

The counterpart of ``experiments/bias_drift.py`` (the reference's
``test.py``): apply an encoder to the same tensor many times in place and
measure the accumulated per-element drift, the property that matters
because training re-quantizes the same weights every optimizer step.
Prints each trial's drift, a histogram of the final error and the mean
drift; same flags and defaults, plus ``--device`` (default ``cuda``: the
encoder's kernels, each call drawing its own noise from one step key).

  python -m smart_quantization_tpu_torch.experiments.bias_drift \\
      --compress smart --repeats 1000 --trials 20
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--compress", default="smart")
    ap.add_argument("--repeats", type=int, default=1000)
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--use_sample_stats", action="store_true")
    ap.add_argument("--num_bits_main", type=int, default=6)
    ap.add_argument("--num_bits_outlier", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> float:
    """Runs the experiment; returns the overall mean drift."""
    import torch

    from smart_quantization_tpu_torch import resolve_device
    from smart_quantization_tpu_torch.compress import build_compressor
    from smart_quantization_tpu_torch.ops.keys import DeviceKey, key_tensor

    args = parse_args(argv)
    device = resolve_device(args.device)
    opts = {}
    if args.compress == "smart":
        opts = dict(num_bits_main=args.num_bits_main, num_bits_outlier=args.num_bits_outlier,
                    use_sample_stats=args.use_sample_stats)
    comp = build_compressor(args.compress, **opts)

    diffs = []
    for trial in range(args.trials):
        data = torch.Generator().manual_seed(2 * trial)
        x = torch.randn(args.size, generator=data).to(device)
        # every call draws fresh noise: the next call index of one key on
        # the card, the next draw of one generator on the CPU
        gen = (DeviceKey(key_tensor(2 * trial + 1, device)) if device.type == "cuda"
               else torch.Generator().manual_seed(2 * trial + 1))
        y = x
        with torch.no_grad():
            for _ in range(args.repeats):
                y, _ = comp(y, gen)
        d = (y - x).cpu().numpy()
        diffs.append(d)
        print(f"trial {trial:3d}: mean drift {d.mean():+.6f}  "
              f"|drift| {np.abs(d).mean():.6f}  max {np.abs(d).max():.4f}")

    all_d = np.concatenate(diffs)
    hist, edges = np.histogram(all_d, bins=21)
    print("\nfinal-drift histogram:")
    for h, lo, hi in zip(hist, edges[:-1], edges[1:]):
        bar = "#" * int(60 * h / max(hist.max(), 1))
        print(f"  [{lo:+.3f},{hi:+.3f}) {h:7d} {bar}")
    print(f"\nOVERALL mean drift after {args.repeats} applications: "
          f"{all_d.mean():+.6f} (|.|={np.abs(all_d).mean():.6f})")
    return float(all_d.mean())


if __name__ == "__main__":
    main()
