"""Serve a small model on the PyTorch/CUDA port with batched requests:
prefill + greedy decode through the production cache machinery (ring
caches for local attention, recurrent states for SSM/RG-LRU).

    PYTHONPATH=src python examples/serve_lm_torch.py [--arch recurrentgemma-2b]
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The twin of ``examples/serve_lm.py`` on ``repro_torch``: the same smoke
config and arguments, served by ``repro_torch.launch.serve.serve``.  On the
card the prefill runs the hand-written kernels (K6 attention, K7 MLP, K8
SSD scan, K9 RG-LRU scan, as the layers ask); ``--device cpu`` runs their
plain versions on the host.  Without a GPU the default raises.
"""
import argparse

from repro_torch.configs import smoke_config
from repro_torch.launch.serve import ServeConfig, serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch).replace(max_seq=args.prompt + args.gen)
    print(f"serving {cfg.name} ({cfg.family}), batch={args.batch}, "
          f"prompt={args.prompt}, gen={args.gen}")
    out = serve(cfg, ServeConfig(batch=args.batch, prompt_len=args.prompt,
                                 gen_len=args.gen), device=args.device)
    print(f"prefill {1e3 * out['prefill_s']:.0f} ms, "
          f"decode {1e3 * out['decode_s']:.0f} ms "
          f"({out['tok_per_s']:.1f} tok/s)")
    for i, row in enumerate(out["tokens"][:2]):
        print(f"request {i}: {row[:16].tolist()} ...")


if __name__ == "__main__":
    main()
