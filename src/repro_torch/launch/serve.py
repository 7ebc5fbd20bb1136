"""Serving driver: batched prefill + greedy decode against a standing KV
cache, on one card or on every rank of a mesh.

    python -m repro_torch.launch.serve --arch recurrentgemma-2b
    python -m repro_torch.launch.serve --arch mamba2-2.7b --batch 4 \
        --prompt 2048 --gen 16
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b \
        --batch 2 --prompt 2048 --gen 16
    python -m repro_torch.launch.serve --arch whisper-base --batch 4 \
        --prompt 128 --gen 16

The counterpart of the JAX package's ``launch/serve.py``.  With ``mesh=``
(a ``launch/mesh.py`` description, inside a process group that the caller
has started; ``main`` does so from ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` and ``--mesh``) each rank serves its rows of the batch
with its shard of the weights and of its rows' cache: FSDP's weights
gathered layer by layer, the ``model`` axis's heads, ``ff`` slices,
widths, experts and vocabulary run split, a cache that keeps its kv
heads whole split by sequence (``launch/distributed.py``), and with
``cp=True`` the prefill's attention context-parallel where the heads are
not split, with ``seq_shard=True`` the stream between blocks split by
sequence (Megatron-SP, ``MeshRun``); every rank returns the whole
batch's tokens and logits.  Either way:
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
from repro_torch.launch.distributed import (MeshRun, close_ranks, init_ranks,
                                            ranks_from_env)
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.sharding import ShardingPlan
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
          params: dict | None = None, mesh: Mesh | None = None,
          plan: ShardingPlan | None = None, cp: bool = False,
          seq_shard: bool = False) -> dict:
    """Serve ``sc.batch`` random prompts.  ``params`` is a ``state_dict``
    of the model (``convert.py::lm_params_from_numpy``), whose tensors the
    model then holds as they are (moved to ``device`` or cast to the
    config's type only where they differ), so a second copy of the weights
    is never made; without it the weights are random, from
    ``torch.Generator(sc.seed)`` on ``device``.  Returns the generated
    ``tokens`` [batch, gen_len], the last step's ``logits`` [batch,
    vocab] and the seconds of the prefill and of the decode steps.  With
    ``mesh`` (and ``plan``, default ``make_plan`` of the config on it)
    this rank serves its rows and returns the whole batch's, and the bytes
    of the parameters and of the cache it placed (``param_bytes``,
    ``cache_bytes``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device (torch.cuda.is_available() "
                           "is False); pass device='cpu' to serve on the "
                           "host")
    run = None if mesh is None else MeshRun(cfg, mesh, plan, device, cp=cp,
                                            seq_shard=seq_shard)
    max_len = sc.prompt_len + sc.gen_len
    run_cfg = cfg.replace(max_seq=max_len)
    rows = slice(0, sc.batch)
    if run is not None:
        # built on the meta device, placed leaf by leaf as this rank's
        # shards
        model = Model(run_cfg, device="meta")
        if params is None:
            run.place_init(model, sc.seed)
        else:
            run.place_loaded(model, params)
        rows = run.rows(sc.batch)
    elif params is None:
        model = Model(run_cfg, device=device).init_weights(sc.seed)
    else:
        model = Model(run_cfg, device="meta")
        dtype = model_dtype(cfg)
        model.load_state_dict({k: v.to(device=device, dtype=dtype)
                               for k, v in params.items()}, assign=True)
    batch_rows = rows.stop - rows.start

    prefill = make_prefill_step(model)
    decode = make_decode_step(model)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(sc.seed)
    prompts = rng.integers(0, cfg.vocab,
                           (sc.batch, sc.prompt_len)).astype(np.int32)
    cache = (model.init_cache(batch_rows, max_len) if run is None
             else run.init_cache(model, sc.batch, max_len))
    placed = {"param_bytes": _nbytes(model.parameters()),
              "cache_bytes": _nbytes(_tensors(cache))}
    sync()
    t0 = time.perf_counter()
    batch = {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
             for name, spec in model.batch_spec(sc.prompt_len, batch_rows,
                                                "prefill").items()}
    batch["tokens"] = torch.from_numpy(prompts[rows]).to(device)
    logits, cache = prefill(batch, cache)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    sync()
    t_prefill = time.perf_counter() - t0

    generated = [next_tok]
    t0 = time.perf_counter()
    for _ in range(sc.gen_len - 1):
        next_tok, logits, cache = decode(cache, next_tok)
        generated.append(next_tok)
    toks = torch.cat(generated, dim=1)
    if run is not None:
        toks = run.gather_rows(toks, sc.batch)
        logits = run.gather_rows(logits, sc.batch)
    toks = toks.cpu().numpy()
    sync()
    t_decode = time.perf_counter() - t0
    return {
        "tokens": toks,
        "logits": logits,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": sc.batch * (sc.gen_len - 1) / max(t_decode, 1e-9),
        **placed,
    }


def _tensors(node):
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, dict):
        for v in node.values():
            yield from _tensors(v)
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    ap.add_argument("--mesh", default=None,
                    help="with RANK / WORLD_SIZE set: the mesh's dims, "
                         "e.g. 4,1 (data, model) or 2,2,1 (pod, data, "
                         "model); default WORLD_SIZE,1")
    ap.add_argument("--store", default=None,
                    help="the process group's init_method (file:///path "
                         "or tcp://host:port; default env://)")
    ap.add_argument("--cp", action="store_true",
                    help="context-parallel prefill attention over the "
                         "mesh's model axis")
    args = ap.parse_args(argv)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    sc = ServeConfig(batch=args.batch, prompt_len=args.prompt,
                     gen_len=args.gen)
    if not ranks_from_env():
        out = serve(cfg, sc, device=args.device)
    else:
        device = init_ranks(args.store, args.device)
        try:
            dims = (tuple(int(n) for n in args.mesh.split(",")) if args.mesh
                    else (torch.distributed.get_world_size(), 1))
            out = serve(cfg, sc, device=device, mesh=make_mesh(dims),
                        cp=args.cp)
        finally:
            close_ranks()
    print(f"prefill {out['prefill_s']:.2f}s, decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s), sample: {out['tokens'][0, :12]}")


if __name__ == "__main__":
    main()
