"""The LM substrate's API, as an ``nn.Module``: serving and the loss.

  model = Model(cfg, device="cuda")            # parameters, uninitialised
  model.init_weights(seed)                     # or load_state_dict(...)
  logits, cache = model.prefill({"tokens": tokens})
  logits, cache = model.decode_step(cache, tokens)
  loss, metrics = model.loss({"tokens": tokens, "labels": labels})

The counterpart of the JAX package's ``models/model.py``: the parameters
live in the module (``embed``, ``layers`` in depth order, ``final_norm``)
instead of a tree passed to every call, and the cache position ``pos`` is a
host ``int``, so no call waits on the device to learn it.  Tokens are int
tensors ``[B, S]`` (decode ``[B, 1]``).  The families the port runs are
dense, hybrid and ssm (``transformer.py::PORTED_KINDS``); a cache holds a
KV cache per attention layer and a fixed-size state per recurrent or ssm
layer (``max_len`` sizes only the former).  Training keeps float32
masters (``param_dtype=torch.float32``, the JAX package's
``init(key, "float32")``) and computes in the config's type.  The vlm and
audio stubs and the MoE MLPs come later.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (D, Params, embed_defs, embed_lookup,
                                       init_params, model_dtype, rms_norm,
                                       unembed)
from repro_torch.models.transformer import (apply_stack, build_stack,
                                            stack_cache)

LOSS_CHUNK = 8192      # tokens per unembed chunk (bounds logits memory)


@dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype


class Model(Params):
    """``param_dtype`` is the parameters' type (default: the config's, for
    serving; training passes ``torch.float32``)."""

    def __init__(self, cfg: ModelConfig, device="cuda", param_dtype=None):
        if cfg.family in ("audio", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family (encoder / cross "
                f"attention stubs) is not ported yet")
        dtype = param_dtype or model_dtype(cfg)
        super().__init__({"final_norm": D((cfg.d_model,), init="zeros")},
                         dtype, device)
        self.cfg = cfg
        self.embed = Params(embed_defs(cfg), dtype, device)
        self.layers = build_stack(cfg, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def init_weights(self, seed: int) -> "Model":
        """Random weights from ``torch.Generator(seed)`` on the model's
        device (``layers.py::init_params``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_params(self, gen)
        return self

    # --------------------------------------------------------------- loss
    def loss(self, batch: dict, remat: str = "full"):
        """``batch["tokens"]``, ``batch["labels"]`` [B, S] (label -1: not
        counted).  Returns ``(nll + aux, {"nll", "aux"})``, float32 scalars;
        aux is 0 for the ported (dense, hybrid, ssm) families."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        x = embed_lookup(self.embed, tokens, cfg)
        x, _ = apply_stack(self.layers, x, cfg, remat=remat)
        x = rms_norm(x, self.final_norm)
        nll = self._chunked_xent(x, self._tokens(batch["labels"]))
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return nll + aux, {"nll": nll, "aux": aux}

    def _chunked_xent(self, x: torch.Tensor, labels: torch.Tensor):
        """Cross entropy over sequence chunks of ``LOSS_CHUNK // B`` tokens
        (the batch stays whole, as in the JAX package), the ragged
        remainder last; each chunk's logits are recomputed in the
        backward instead of kept."""
        B, S, _ = x.shape
        chunk = min(max(1, LOSS_CHUNK // B), S)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int64, device=x.device)
        for start in range(0, S, chunk):
            t, c = checkpoint(self._chunk_nll, x[:, start:start + chunk],
                              labels[:, start:start + chunk],
                              use_reentrant=False)
            tot, cnt = tot + t, cnt + c
        return tot / torch.clamp(cnt, min=1)

    def _chunk_nll(self, xc: torch.Tensor, lc: torch.Tensor):
        """(sum of the negative log-likelihoods, count) of one chunk."""
        logits = unembed(self.embed, xc, self.cfg)
        mask = lc != -1
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
        """``batch["tokens"] [B, S]``; returns (logits [B, V] float32 of the
        last position, cache)."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        if cache is None:
            # the cache must cover the planned decode horizon, not just S
            cache = self.init_cache(B, max(cfg.max_seq, S))
        pos = cache["pos"]
        x = embed_lookup(self.embed, tokens, cfg)
        x, layers = apply_stack(self.layers, x, cfg, cache=cache["layers"],
                                pos=pos)
        x = rms_norm(x, self.final_norm)
        return self._last_logits(x), {"layers": layers, "pos": pos + S}

    @torch.no_grad()
    def decode_step(self, cache: dict, tokens):
        """tokens [B, 1]; returns (logits [B, V], new_cache)."""
        cfg = self.cfg
        tokens = self._tokens(tokens)
        pos = cache["pos"]
        x = embed_lookup(self.embed, tokens, cfg)
        x, layers = apply_stack(self.layers, x, cfg, cache=cache["layers"],
                                pos=pos)
        x = rms_norm(x, self.final_norm)
        return (self._last_logits(x),
                {"layers": layers, "pos": pos + tokens.shape[1]})

    def _last_logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.embed, x[:, -1], self.cfg)

    # --------------------------------------------------------- batch specs
    def batch_spec(self, seq_len: int, batch: int, mode: str) -> dict:
        """Shape and type of every model input of a cell."""
        if mode == "train":
            return {"tokens": TensorSpec((batch, seq_len), torch.int32),
                    "labels": TensorSpec((batch, seq_len), torch.int32)}
        if mode == "prefill":
            return {"tokens": TensorSpec((batch, seq_len), torch.int32)}
        if mode == "decode":
            return {"tokens": TensorSpec((batch, 1), torch.int32)}
        raise ValueError(f"mode {mode!r} not in (train, prefill, decode)")
