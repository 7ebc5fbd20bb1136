"""The LM substrate's API, as an ``nn.Module``: serving and the loss.

  model = Model(cfg, device="cuda")            # parameters, uninitialised
  model.init_weights(seed)                     # or load_state_dict(...)
  logits, cache = model.prefill({"tokens": tokens})
  logits, cache = model.decode_step(cache, tokens)
  loss, metrics = model.loss({"tokens": tokens, "labels": labels})

The counterpart of the JAX package's ``models/model.py``: the parameters
live in the module (``embed``, ``layers`` in depth order, ``final_norm``;
for audio also ``enc_layers`` and ``enc_norm``) instead of a tree passed to
every call, and the cache position ``pos`` is a host ``int``, so no call
waits on the device to learn it.  Tokens are int tensors ``[B, S]``
(decode ``[B, 1]``).  The port runs every family of the JAX package --
dense, moe, hybrid, ssm, audio and vlm (the layer kinds of
``transformer.py::PORTED_KINDS``) -- with its stubs as there:

  audio adds  "frames":  [B, enc_seq, d]    (conv frontend STUB)
  vlm   adds  "patches": [B, vision_seq, d] (vision tower STUB)

to the batch of a prefill or the loss: the context, which the encoder
(audio: frames plus a sinusoidal table, the encoder stack, its norm) or
nothing (vlm) turns into the keys and values of the cross-attention.  A
decode step takes no context.  A cache holds a KV cache per attention
layer, the context's keys and values per cross layer, and a fixed-size
state per recurrent or ssm layer (``max_len`` sizes only the first).
Training keeps float32 masters (``param_dtype=torch.float32``, the JAX
package's ``init(key, "float32")``) and computes in the config's type; the
loss adds the MoE layers' aux loss.  A model placed on a mesh whose
``model`` axis is above 1 holds the axis as ``tp``
(``launch/distributed.py::MeshRun.place``) and passes it to every block;
its logits come back whole, and its loss is the vocabulary-parallel cross
entropy.  Under Megatron-SP (the axis's ``seq``, ``MeshRun(...,
seq_shard=True)``) the stream between the embedding and the final norm
is each rank's shard of the sequence (the audio encoder's too, its
output gathered whole for the cross-attention); the loss gathers the
sequence before the unembedding, a prefill only the last positions.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (D, Params, embed_defs, embed_lookup,
                                       gather_sequence, init_params,
                                       model_dtype, on_shard,
                                       partition_specs, rms_norm, unembed,
                                       vocab_parallel_nll)
from repro_torch.models.transformer import (apply_stack, build_stack,
                                            stack_cache)

LOSS_CHUNK = 8192      # tokens per unembed chunk (bounds logits memory)


def _sinusoidal(seq: int, d: int) -> np.ndarray:
    """The audio encoder's position table, the JAX package's, float32."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


@dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


class Model(Params):
    """``param_dtype`` is the parameters' type (default: the config's, for
    serving; training passes ``torch.float32``)."""

    def __init__(self, cfg: ModelConfig, device="cuda", param_dtype=None):
        dtype = param_dtype or model_dtype(cfg)
        defs = {"final_norm": D((cfg.d_model,), ("embed",),
                                init="zeros")}
        if cfg.family == "audio":
            defs["enc_norm"] = D((cfg.d_model,), ("embed",),
                                 init="zeros")
        super().__init__(defs, dtype, device)
        self.cfg = cfg
        self.tp = None
        self.embed = Params(embed_defs(cfg), dtype, device)
        if cfg.family == "audio":
            self.enc_layers = build_stack(cfg, dtype, device, decoder=False)
        self.layers = build_stack(cfg, dtype, device)

    @property
    def device(self) -> torch.device:
        # the stored tensor, not an attribute a mesh run may gather
        # (``launch/distributed.py``)
        return next(self.parameters()).device

    def pspecs(self, rules: dict) -> dict:
        """``{parameter name: spec}`` of every parameter under a plan's
        ``rules`` (``layers.py::partition_specs``), by the names of
        ``named_parameters`` without FSDP's wrapping
        (``convert.py::lm_params_to_numpy`` maps them to the JAX tree)."""
        out = {}
        for prefix, mod in self.named_modules():
            if isinstance(mod, Params):
                for name, spec in partition_specs(mod.defs, rules).items():
                    out[f"{prefix}.{name}" if prefix else name] = spec
        return out

    def init_weights(self, seed: int) -> "Model":
        """Random weights from ``torch.Generator(seed)`` on the model's
        device (``layers.py::init_params``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_params(self, gen)
        return self

    # -------------------------------------------------------------- stubs
    def _context(self, batch: dict):
        """The cross-attention's context of a batch: audio's encoded frames,
        vlm's patches in the model's type; None for the other families."""
        cfg = self.cfg
        dtype = model_dtype(cfg)
        if cfg.family == "audio":
            frames = torch.as_tensor(batch["frames"],
                                     device=self.device).to(dtype)
            # the table reaches the device by a copy into a device tensor
            # (a host tensor's ``.to(device)`` has no fake counterpart in a
            # traced step, ``launch/dryrun.py::trace_cell``)
            pe = torch.empty(frames.shape[1:], dtype=dtype,
                             device=frames.device).copy_(torch.from_numpy(
                                 _sinusoidal(frames.shape[1], cfg.d_model)))
            x = frames + pe
            tp = self._stream(x.shape[1])
            if tp is not None and tp.seq:
                x = tp.scatter(x, 1)
            x, _, _ = apply_stack(self.enc_layers, x, cfg, remat="none",
                                  tp=tp)
            x = rms_norm(x, on_shard(self.enc_norm, tp))
            return x if tp is None or not tp.seq else tp.gather(x, 1)
        if cfg.family == "vlm":
            return torch.as_tensor(batch["patches"],
                                   device=self.device).to(dtype)
        return None

    # --------------------------------------------------------------- loss
    def loss(self, batch: dict, remat: str = "full"):
        """``batch["tokens"]``, ``batch["labels"]`` [B, S] (label -1: not
        counted), and audio's ``frames`` / vlm's ``patches``.  Returns
        ``(nll + aux, {"nll", "aux"})``, float32 scalars; aux is the MoE
        layers' router loss, 0 for the other families."""
        cfg = self.cfg
        ctx = self._context(batch)
        tokens = self._tokens(batch["tokens"])
        tp = self._stream(tokens.shape[1])
        x = embed_lookup(self.embed, tokens, cfg, tp)
        x, _, aux = apply_stack(self.layers, x, cfg, ctx=ctx, remat=remat,
                                tp=tp)
        x = gather_sequence(rms_norm(x, on_shard(self.final_norm, tp)), tp)
        nll = self._chunked_xent(x, self._tokens(batch["labels"]),
                                 enter=tp is None or not tp.seq)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return nll + aux, {"nll": nll, "aux": aux}

    def _stream(self, length: int):
        """The model axis for a stream of ``length`` positions (Megatron-SP
        kept only where the ranks split it, ``ModelAxis.on_sequence``);
        None without one."""
        return None if self.tp is None else self.tp.on_sequence(length)

    def _chunked_xent(self, x: torch.Tensor, labels: torch.Tensor,
                      enter: bool = True):
        """Cross entropy over sequence chunks of ``LOSS_CHUNK // B`` tokens
        (the batch stays whole, as in the JAX package), the ragged
        remainder last; each chunk's logits are recomputed in the
        backward instead of kept.  ``enter``: see ``layers.unembed``."""
        B, S, _ = x.shape
        chunk = min(max(1, LOSS_CHUNK // B), S)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int64, device=x.device)
        for start in range(0, S, chunk):
            t, c = checkpoint(self._chunk_nll, x[:, start:start + chunk],
                              labels[:, start:start + chunk], enter,
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + c
        return tot / torch.clamp(cnt, min=1)

    def _chunk_nll(self, xc: torch.Tensor, lc: torch.Tensor,
                   enter: bool = True):
        """(sum of the negative log-likelihoods, count) of one chunk."""
        tp = self.tp
        mask = lc != -1
        if tp is not None and tp.vocab:
            logits = unembed(self.embed, xc, self.cfg, tp, gather=False,
                             enter=enter)
            nll = vocab_parallel_nll(logits, lc.clamp(min=0), tp)
            return (nll * mask).sum(), mask.sum()
        logits = unembed(self.embed, xc, self.cfg)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            lc.clamp(min=0).long()[..., None])[..., 0]
        return ((lse - gold) * mask).sum(), mask.sum()

    # ------------------------------------------------------------ serving
    def init_cache(self, batch: int, max_len: int) -> dict:
        return {"layers": stack_cache(self.cfg, batch, max_len,
                                      model_dtype(self.cfg), self.device),
                "pos": 0}

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device)

    @torch.no_grad()
    def prefill(self, batch: dict, cache: dict | None = None):
        """``batch["tokens"] [B, S]`` (and audio's ``frames`` / vlm's
        ``patches``); returns (logits [B, V] float32 of the last position,
        cache)."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        if cache is None:
            # the cache must cover the planned decode horizon, not just S
            cache = self.init_cache(B, max(cfg.max_seq, S))
        pos = cache["pos"]
        ctx = self._context(batch)
        tp = self._stream(S)
        x = embed_lookup(self.embed, tokens, cfg, tp)
        x, layers, _ = apply_stack(self.layers, x, cfg,
                                   cache=cache["layers"], pos=pos, ctx=ctx,
                                   fill_cross=True, tp=tp)
        x = rms_norm(x, self.final_norm)
        if tp is not None and tp.seq:
            # the last position is the last rank's: every rank's last, the
            # last of them
            x = tp.gather(x[:, -1:], 1)
        return self._last_logits(x), {"layers": layers, "pos": pos + S}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens):
        """tokens [B, 1]; returns (logits [B, V], new_cache)."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        pos = cache["pos"]
        tp = self._stream(tokens.shape[1])
        x = embed_lookup(self.embed, tokens, cfg, tp)
        x, layers, _ = apply_stack(self.layers, x, cfg,
                                   cache=cache["layers"], pos=pos, tp=tp)
        x = rms_norm(x, self.final_norm)
        return (self._last_logits(x),
                {"layers": layers, "pos": pos + tokens.shape[1]})

    def _last_logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.embed, x[:, -1], self.cfg, self.tp)

    # --------------------------------------------------------- batch specs
    def batch_spec(self, seq_len: int, batch: int, mode: str) -> dict:
        """Shape and type of every model input of a cell."""
        cfg = self.cfg
        i32 = torch.int32
        if mode == "train":
            spec = {"tokens": TensorSpec((batch, seq_len), i32),
                    "labels": TensorSpec((batch, seq_len), i32)}
        elif mode == "prefill":
            spec = {"tokens": TensorSpec((batch, seq_len), i32)}
        elif mode == "decode":
            return {"tokens": TensorSpec((batch, 1), i32)}
        else:
            raise ValueError(f"mode {mode!r} not in (train, prefill, decode)")
        if cfg.family == "audio":
            spec["frames"] = TensorSpec((batch, cfg.enc_seq, cfg.d_model),
                                        torch.bfloat16)
        if cfg.family == "vlm":
            spec["patches"] = TensorSpec(
                (batch, cfg.vision_seq, cfg.d_model), torch.bfloat16)
        return spec
