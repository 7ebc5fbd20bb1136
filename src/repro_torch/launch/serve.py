"""Serving driver: batched prefill + greedy decode against a standing KV
cache, on one card.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch mamba2-2.7b --batch 4 \
        --prompt 2048 --gen 16
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --batch 2 --prompt 2048 --gen 16
    python -m repro_torch.launch.serve --arch whisper-base --batch 4 \
        --prompt 128 --gen 16

The counterpart of the JAX package's ``launch/serve.py``, without its mesh:
the prompts (``numpy.random.default_rng(seed)``, as there), a prefill of
``prompt_len`` tokens (``launch/steps.py::make_prefill_step``), then
``gen_len - 1`` greedy decode steps (``make_decode_step``).  Every other
input of ``Model.batch_spec`` (audio's frames, vlm's patches) is zeros in
its type, bfloat16, as the JAX ``serve()`` gives them.  On the card the
prefill runs the hand-written kernels K6 (attention of every attention
layer, self- and cross-attention, and of whisper's encoder), K9 (the scan
of every recurrent layer), K8 (the SSD scan of every ssm layer) and K7
(every dense MLP), and each decode step K7 (ssm layers have no MLP: a
mamba2 decode step runs no kernel; the MoE experts are batched products in
torch: a moonshot serve launches K6 only).  Times are host clock around
work that ends in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.layers import model_dtype
from repro_torch.models.model import Model


@dataclass
class ServeConfig:
    batch: int = 4
    prompt_len: int = 32
    gen_len: int = 32
    seed: int = 0


def serve(cfg: ModelConfig, sc: ServeConfig, device="cuda",
          params: dict | None = None) -> dict:
    """Serve ``sc.batch`` random prompts.  ``params`` is a ``state_dict``
    of the model (``convert.py::lm_params_from_numpy``), whose tensors the
    model then holds as they are (moved to ``device`` or cast to the
    config's type only where they differ), so a second copy of the weights
    is never made; without it the weights are random, from
    ``torch.Generator(sc.seed)`` on ``device``.  Returns the generated
    ``tokens`` [batch, gen_len] and the seconds of the prefill and of the
    decode steps."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device (torch.cuda.is_available() "
                           "is False); pass device='cpu' to serve on the "
                           "host")
    max_len = sc.prompt_len + sc.gen_len
    run_cfg = cfg.replace(max_seq=max_len)
    if params is None:
        model = Model(run_cfg, device=device).init_weights(sc.seed)
    else:
        model = Model(run_cfg, device="meta")
        dtype = model_dtype(cfg)
        model.load_state_dict({k: v.to(device=device, dtype=dtype)
                               for k, v in params.items()}, assign=True)

    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(sc.seed)
    prompts = rng.integers(0, cfg.vocab,
                           (sc.batch, sc.prompt_len)).astype(np.int32)
    cache = model.init_cache(sc.batch, max_len)
    sync()
    t0 = time.perf_counter()
    batch = {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
             for name, spec in model.batch_spec(sc.prompt_len, sc.batch,
                                                "prefill").items()}
    batch["tokens"] = torch.from_numpy(prompts).to(device)
    logits, cache = prefill(batch, cache)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    sync()
    t_prefill = time.perf_counter() - t0

    generated = [next_tok]
    t0 = time.perf_counter()
    for _ in range(sc.gen_len - 1):
        next_tok, logits, cache = decode(cache, next_tok)
        generated.append(next_tok)
    toks = torch.cat(generated, dim=1).cpu().numpy()
    sync()
    t_decode = time.perf_counter() - t0
    return {
        "tokens": toks,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": sc.batch * (sc.gen_len - 1) / max(t_decode, 1e-9),
    }


def main(argv=None) -> None:
    import argparse
    from repro_torch.configs import get_config, smoke_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    out = serve(cfg, ServeConfig(batch=args.batch, prompt_len=args.prompt,
                                 gen_len=args.gen), device=args.device)
    print(f"prefill {out['prefill_s']:.2f}s, decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s), sample: {out['tokens'][0, :12]}")


if __name__ == "__main__":
    main()
