"""The port's analytic cost model (``repro_torch/utils/costmodel.py``)
against the JAX package's (``repro/utils/costmodel.py``) on all 10
configs: every number equal (``==``), since both are plain Python floats
summed in the same order."""
import pytest

import repro.utils.costmodel as ref
from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import ShapeCell as RefCell

import repro_torch.utils.costmodel as port
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ShapeCell
import torch_parity

torch_parity.one_thread()

ARCH_NAMES = sorted(ARCHS)
MODES = ("train", "prefill", "decode")
# (S, kv_len) pairs: a training / prefill sequence with the mean causal
# length, a decode step against a long cache, and odd sizes
LENGTHS = ((512, 512), (512, 256.5), (1, 4096), (37, 19.0), (4096, 2048.5))
# (name, seq_len, global_batch, mode, remat)
CELLS = (("smollm_train", 512, 8, "train", "full"),
         ("smollm_train", 512, 8, "train", "dots"),
         ("train_4k", 4096, 256, "train", "none"),
         ("prefill_32k", 32768, 32, "prefill", "full"),
         ("decode_32k", 32768, 128, "decode", "full"),
         ("long_500k", 524288, 1, "decode", "full"))


def test_the_two_packages_have_the_same_configs():
    assert sorted(REF_ARCHS) == ARCH_NAMES
    for name in ARCH_NAMES:
        assert str(get_config(name)) == str(REF_ARCHS[name])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_flops_equal_the_reference(arch, mode):
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    for s, kv in LENGTHS:
        got = port.forward_flops(cfg, s, kv, mode)
        assert type(got) is float and got > 0
        assert got == ref.forward_flops(rcfg, s, kv, mode), (s, kv)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_unembed_flops_and_attention_fraction_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    for tokens in (1, 8, 4096, 8 * 512.0):
        assert port.unembed_flops(cfg, tokens) == \
            ref.unembed_flops(rcfg, tokens)
    for mode in MODES:
        for s, kv in LENGTHS:
            got = port.attention_fraction(cfg, s, kv, mode)
            assert 0.0 <= got <= 1.0
            assert got == ref.attention_fraction(rcfg, s, kv, mode)


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[4]}")
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cell_cost_equals_the_reference(arch, cell):
    name, seq, batch, mode, remat = cell
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    for chips in (1, 4):
        for dtype_bytes in (2, 4):
            got = port.cell_cost(cfg, ShapeCell(name, seq, batch, mode),
                                 chips, remat=remat, dtype_bytes=dtype_bytes)
            want = ref.cell_cost(rcfg, RefCell(name, seq, batch, mode),
                                 chips, remat=remat, dtype_bytes=dtype_bytes)
            assert (got.flops, got.weight_bytes, got.act_bytes, got.notes) \
                == (want.flops, want.weight_bytes, want.act_bytes,
                    want.notes)
            assert got.per_device(chips) == want.per_device(chips)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_kv_bytes_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), REF_ARCHS[arch]
    for b, s, dtype_bytes in ((1, 1, 2), (8, 512, 2), (128, 32768, 2),
                              (2, 3071, 4)):
        assert port._kv_bytes(cfg, b, s, dtype_bytes) == \
            ref._kv_bytes(rcfg, b, s, dtype_bytes)


def test_train_remat_factor_and_the_smollm_count():
    """4 passes of the forward under remat="full", 3 otherwise; and the
    JAX package's number for smollm-360m's training forward."""
    cfg = get_config("smollm-360m")
    assert port.forward_flops(cfg, 512, 512, "train") == 354334801920.0
    cell = ShapeCell("smollm_train", 512, 8, "train")
    full = port.cell_cost(cfg, cell, 1, remat="full")
    dots = port.cell_cost(cfg, cell, 1, remat="dots")
    assert full.flops / dots.flops == 4.0 / 3.0
    assert dots.notes == "remat=dots factor=3.0"
