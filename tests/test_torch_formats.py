"""The port's quantized block storage against ``repro.core.formats`` on
shared numpy inputs: payload bits (fp8 through a ``uint8`` view, since
``torch.from_numpy`` takes no ``ml_dtypes`` array), scales, the fp32
reconstruction and the error bounds; and the carry-over of ``repro``'s
quantized blocks into the port (``convert.quantized_blocks_from_jax``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import formats as jf  # noqa: E402

from repro_torch.convert import quantized_blocks_from_jax  # noqa: E402
from repro_torch.core import formats  # noqa: E402
from repro_torch.core.formats import (BSR, QuantizedBlocks,  # noqa: E402
                                      dequantize_blocks, quantize_blocks)

MODES = list(jf.QUANT_MODES)


def _blocks(seed=0, shape=(40, 32, 64)):
    """Gaussian tiles with outliers, an all-zero block and an all-zero
    row (their scale is 1.0), and exact ties for the rounding."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(shape).astype(np.float32)
    b[1] *= 1e3
    b[2, 3, 5] = 40.0
    b[3] = 0.0
    b[4, 7] = 0.0
    b[5] = np.linspace(-127, 127, b[5].size, dtype=np.float32).reshape(
        b[5].shape)
    return b


def _u8(payload):
    """Payload bits as uint8, from either package."""
    if isinstance(payload, torch.Tensor):
        return payload.view(torch.uint8).numpy()
    return np.asarray(payload).view(np.uint8)


def test_quant_constants_match_repro():
    assert formats.QUANT_MODES == jf.QUANT_MODES
    assert formats.QUANT_MAX == jf.QUANT_MAX
    assert formats.ROWWISE_SUFFIX == jf.ROWWISE_SUFFIX
    for name, dt in formats.QUANT_DTYPES.items():
        assert dt.itemsize == jf.QUANT_DTYPES[name].itemsize == 1
    for mode in MODES + ["fp32"]:
        assert formats.quant_base_dtype(mode) == jf.quant_base_dtype(mode)
        assert formats.quant_is_rowwise(mode) == jf.quant_is_rowwise(mode)


@pytest.mark.parametrize("mode", MODES)
def test_quantize_blocks_bit_equal_to_repro(mode):
    b = _blocks()
    got = quantize_blocks(b, mode)
    want = jf.quantize_blocks(b, mode)
    assert got.dtype == want.dtype == mode
    assert got.payload.dtype == formats.QUANT_DTYPES[mode.split(".")[0]]
    np.testing.assert_array_equal(_u8(got.payload), _u8(want.payload))
    assert got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.scales.numpy(), want.scales)
    assert got.nbytes == want.nbytes
    assert got.block_shape == want.block_shape
    # the same tiles as a torch tensor give the same bits
    again = quantize_blocks(torch.from_numpy(b), mode)
    np.testing.assert_array_equal(_u8(again.payload), _u8(want.payload))


@pytest.mark.parametrize("mode", MODES)
def test_dequantize_and_error_bound_match_repro(mode):
    b = _blocks(1)
    got = dequantize_blocks(quantize_blocks(b, mode))
    want = jf.dequantize_blocks(jf.quantize_blocks(b, mode))
    np.testing.assert_array_equal(got.numpy(), want)
    bound = formats.quant_error_bound(mode)
    assert bound == jf.quant_error_bound(mode)
    # the bound holds per scale group: per row of each block in a rowwise
    # mode, per block otherwise
    axis = 2 if mode.endswith(".rowwise") else (1, 2)
    amax = np.abs(b).max(axis=axis, keepdims=True)
    assert (np.abs(got.numpy() - b) <= bound * amax + 1e-6).all()


def test_quantize_rejects_what_repro_rejects():
    for bad in ("int4", "int8.colwise", "fp16"):
        with pytest.raises(ValueError, match="unknown quantized block dtype"):
            quantize_blocks(_blocks(), bad)
        with pytest.raises(ValueError, match="unknown quantized block dtype"):
            jf.quantize_blocks(_blocks(), bad)
    with pytest.raises(ValueError, match="must be"):
        quantize_blocks(np.zeros((4, 4), np.float32), "int8")


@pytest.mark.parametrize("mode", MODES)
def test_quantized_blocks_from_jax_round_trips(mode):
    b = _blocks(2)
    jq = jf.quantize_blocks(b, mode)
    got = quantized_blocks_from_jax(jq.payload.view(np.uint8)
                                    if mode.startswith("fp8") else jq.payload,
                                    jq.scales, jq.dtype)
    assert isinstance(got, QuantizedBlocks) and got.dtype == mode
    mine = quantize_blocks(b, mode)
    assert got.payload.dtype == mine.payload.dtype
    np.testing.assert_array_equal(_u8(got.payload), _u8(jq.payload))
    np.testing.assert_array_equal(got.scales.numpy(), jq.scales)
    np.testing.assert_array_equal(dequantize_blocks(got).numpy(),
                                  jf.dequantize_blocks(jq))
    with pytest.raises(ValueError, match="1-byte"):
        quantized_blocks_from_jax(b, jq.scales, mode)


def test_block_mask_matches_repro():
    a = BSR.random(np.random.default_rng(4), (320, 224), (32, 32), 0.3)
    ja = jf.BSR(a.shape, a.block_shape, a.brow, a.bcol, a.blocks)
    np.testing.assert_array_equal(a.block_mask(), ja.block_mask())
