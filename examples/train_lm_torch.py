"""End-to-end training on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps with the full production stack (pipeline, AdamW,
checkpointing, preemption guard, straggler monitor).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The twin of ``examples/train_lm.py`` on ``repro_torch``: the same
width-reduced smollm (same family/code path as the assigned arch) in
float32, the same data, optimizer and schedule, trained by
``repro_torch.launch.train.train`` on the card (K6 and K7, float32 on their
SIMT kernels, in every layer's forward and again in its recomputation);
``--device cpu`` trains on the host.  Without a GPU the default raises.
Loss should fall from ~ln(V)=9.6 by more than one nat (checked).
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import TrainConfig, train
from repro_torch.optim.adamw import AdamWConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    # ~100M params: smollm family, 12 layers, d=640
    cfg = get_config("smollm-360m").replace(
        name="smollm-100m", n_layers=12, d_model=640, n_heads=8,
        n_kv_heads=4, head_dim=80, d_ff=1920, max_seq=args.seq,
        dtype="float32")
    print(f"training {cfg.name}: {cfg.param_count() / 1e6:.0f}M params, "
          f"seq {args.seq}, batch {args.batch}")

    dc = DataConfig(seq_len=args.seq, global_batch=args.batch,
                    vocab=cfg.vocab, seed=0)
    tc = TrainConfig(steps=args.steps, log_every=20, ckpt_every=100,
                     ckpt_dir=args.ckpt_dir,
                     opt=AdamWConfig(lr=6e-4, warmup_steps=50,
                                     total_steps=args.steps))
    out = train(cfg, tc, data_cfg=dc, device=args.device)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"\nloss {first:.3f} -> {last:.3f} in {out['wall_s']:.0f}s "
          f"({len(out['stragglers'])} straggler steps flagged)")
    if not last < first - 1.0:
        raise AssertionError("loss should drop by >1 nat")


if __name__ == "__main__":
    main()
