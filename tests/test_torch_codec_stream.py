"""The port's escape-stream codec and LZW baseline against the JAX
package's (host numpy both), on the same seeded uint8 arrays: streams
byte-equal, round trips exact, the accounting equal.  Integer work, so
every comparison is exact."""
import numpy as np
import pytest
import torch

from repro.core import codec as JC
from repro.core import lzw as JL

from repro_torch.core import codec as TC
from repro_torch.core import lzw as TL


def _arrays(seed=0):
    """Quantized-weight-like uint8 arrays: codes concentrated near a zero
    point (so grams repeat), lengths not all divisible by 4."""
    rng = np.random.default_rng(seed)

    def one(shape):
        return np.clip(np.round(rng.laplace(128, 3, shape)), 0,
                       255).astype(np.uint8)
    return {"a": one((64, 48)), "b": one((33, 7)), "c": one((5,)),
            "d": one((2, 3, 17))}


@pytest.mark.parametrize("seq_len", [4, 3])
def test_streams_byte_equal_and_round_trip(seq_len):
    arrays = _arrays()
    jt, js = JC.compress_model_arrays(arrays, seq_len)
    tt, ts = TC.compress_model_arrays(arrays, seq_len)
    assert tt == jt
    for name in arrays:
        assert ts[name].stream.dtype == np.uint16
        np.testing.assert_array_equal(ts[name].stream, js[name].stream)
        assert (ts[name].orig_len, ts[name].shape) == (js[name].orig_len,
                                                       js[name].shape)
    back = TC.decompress_model_arrays(tt, ts)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
        np.testing.assert_array_equal(
            TC.decompress_array(js[name].stream, jt, a.size, seq_len),
            JC.decompress_array(js[name].stream, jt, a.size, seq_len))
    assert TC.table_nbytes(tt, seq_len) == JC.table_nbytes(jt, seq_len)
    assert TC.compression_ratio(arrays, ts, tt) == \
        JC.compression_ratio(arrays, js, jt)


@pytest.mark.parametrize("case", ["no_table", "all_escape", "tensor_in",
                                  "small_table"])
def test_stream_edge_cases_byte_equal(case):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 101).astype(np.uint8)
    table = {}
    if case == "small_table":
        table = JC.find_frequent_sequences([np.tile(a[:8], 20)], 4,
                                           max_codes=3)
    elif case == "all_escape":
        table = {(255, 255, 255, 254): 0}
    ref = JC.compress_array(a, table)
    got = TC.compress_array(torch.from_numpy(a) if case == "tensor_in"
                            else a, table)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(TC.decompress_array(got, table, a.size), a)


def test_unknown_codeword_raises():
    with pytest.raises(KeyError):
        TC.decompress_array(np.array([7], np.uint16), {(1, 2, 3, 4): 0}, 4)


@pytest.mark.parametrize("kind", ["peaked", "random", "runs", "empty"])
def test_lzw_byte_equal(kind):
    rng = np.random.default_rng(2)
    data = {"peaked": np.clip(rng.laplace(128, 2, 3000), 0, 255),
            "random": rng.integers(0, 256, 2000),
            "runs": np.repeat(rng.integers(0, 4, 50), 40),
            "empty": np.zeros(0)}[kind].astype(np.uint8)
    enc = TL.lzw_encode(data)
    np.testing.assert_array_equal(enc, JL.lzw_encode(data))
    np.testing.assert_array_equal(TL.lzw_decode(enc, data.size), data)
    assert TL.lzw_ratio(data) == JL.lzw_ratio(data) if data.size else True
