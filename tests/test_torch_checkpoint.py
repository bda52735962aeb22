"""The port's msgpack codec and checkpoint files against flax's
(``flax.serialization.msgpack_serialize`` / ``msgpack_restore``) and the
JAX package's ``mrn_tpu/train/checkpoint.py``: the port writes the same
bytes for the same tree, reads flax's bytes leaf for leaf bitwise, and the
files cross both ways."""

import copy
import os
import pickle

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import mrn_tpu.train.checkpoint as jax_ckpt
from mrn_tpu_torch.train import checkpoint, msgpack_codec
from mrn_tpu_torch.train.msgpack_codec import msgpack_restore, msgpack_serialize


def _trees():
    rng = np.random.default_rng(7)
    return {
        "arrays": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                   "f64": rng.standard_normal(5),
                   "i8": np.arange(-5, 5, dtype=np.int8),
                   "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, (2, 3), dtype=np.int32),
                   "i64": np.array([-2 ** 63, 2 ** 63 - 1, 0], np.int64),
                   "u8": np.arange(256, dtype=np.uint8).reshape(16, 16),
                   "bool": np.array([[True, False], [False, True]]),
                   "empty": np.zeros((0, 3), np.float32),
                   "zero_d": np.array(2.5, np.float32),
                   "transposed": np.arange(12, dtype=np.float32).reshape(3, 4).T},
        "bf16": {"w": jnp.asarray(rng.standard_normal((4, 5)), jnp.bfloat16),
                 "scalar": jnp.bfloat16(1.5)},
        "scalars": {"np_f64": np.float64(0.1), "np_f32": np.float32(-2.5),
                    "np_i64": np.int64(-7), "np_u8": np.uint8(200), "np_bool": np.bool_(False),
                    "py_float": 0.1, "py_int": 5, "py_bool": True, "none": None,
                    "c": 1.5 - 2j},
        "python": {"b": b"\x00\x01" * 40, "s": "café 一", "long_s": "x" * 300,
                   "list": [1, "a", None, [2.0, {"z": 1, "a": 2}], []],
                   "nested": {"z": {"y": {}}, "a": []}, "long_list": list(range(20)),
                   "wide": {f"k{i}": i for i in range(17)}},
        "ints": {"values": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                            -2 ** 31, -2 ** 31 - 1, -2 ** 63]},
        "unsorted": {"b": 1, "a": {"d": 2, "c": 3}, "B": 4, "_": 5},
        "payload_sizes": {f"n{n}": np.zeros(n, np.uint8) for n in
                          (1, 2, 3, 4, 8, 16, 17, 200, 300, 70000)},
    }


def _port_form(tree):
    """The tree with every jax bfloat16 leaf as a torch.bfloat16 tensor."""
    if isinstance(tree, dict):
        return {k: _port_form(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_form(v) for v in tree]
    if isinstance(tree, (jax.Array, np.ndarray, np.generic)) and tree.dtype == jnp.bfloat16:
        bits = np.asarray(tree).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).reshape(np.shape(tree))
    return tree


def _assert_same(got, ref, path="/"):
    """Leaf for leaf: structure, types, dtype names, shapes and bytes."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            _assert_same(got[k], ref[k], f"{path}{k}/")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{path}{i}/")
    elif isinstance(ref, (np.ndarray, np.generic)):
        if ref.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == np.shape(ref), path
            assert got.view(torch.uint16).numpy().tobytes() == np.asarray(ref).tobytes(), path
        else:
            assert type(got) is type(ref), path
            assert got.dtype == ref.dtype and np.shape(got) == np.shape(ref), path
            assert np.asarray(got).tobytes() == np.asarray(ref).tobytes(), path
    else:
        assert type(got) is type(ref), path
        assert got == ref or (got != got and ref != ref), path


@pytest.mark.parametrize("name", list(_trees()))
def test_bytes_equal_flax(name):
    tree = _trees()[name]
    ref = flax.serialization.msgpack_serialize(tree)
    assert msgpack_serialize(_port_form(tree)) == ref
    if name == "bf16":   # a numpy bfloat16 array (ml_dtypes here) writes alike
        assert msgpack_serialize(jax.tree_util.tree_map(np.asarray, tree)) == ref


@pytest.mark.parametrize("name", list(_trees()))
def test_reads_flax_bytes_bitwise(name):
    data = flax.serialization.msgpack_serialize(_trees()[name])
    _assert_same(msgpack_restore(data), flax.serialization.msgpack_restore(data))


def test_strict_types_and_refusals():
    # np.float64 is a Python float subclass: an ext-3 scalar, not a float
    assert msgpack_serialize(np.float64(1.0))[:1] == b"\xc7"
    assert msgpack_serialize(1.0) == b"\xcb" + np.float64(1.0).byteswap().tobytes()
    assert msgpack_serialize(True) == b"\xc3"   # bool before int
    for bad in ((1, 2), {1, 2}, object(), 2 ** 64, -2 ** 63 - 1):
        with pytest.raises((TypeError, OverflowError)):
            msgpack_serialize({"x": bad})
        with pytest.raises((TypeError, OverflowError)):
            flax.serialization.msgpack_serialize({"x": bad})
    with pytest.raises(ValueError):
        msgpack_restore(flax.serialization.msgpack_serialize({"a": 1})[:-1])


_LEAF_DTYPES = st.sampled_from([np.float32, np.float64, np.int8, np.int32, np.int64,
                                np.uint8, np.bool_])


def _array_leaf():
    return _LEAF_DTYPES.flatmap(lambda dt: hnp.arrays(
        dt, hnp.array_shapes(min_dims=0, max_dims=3, max_side=5)))


_LEAVES = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(allow_nan=False), st.text(max_size=40), st.binary(max_size=40),
    _array_leaf(),
    _LEAF_DTYPES.flatmap(lambda dt: hnp.from_dtype(np.dtype(dt)).map(dt)))

_TREES = st.recursive(
    _LEAVES,
    lambda children: st.one_of(st.lists(children, max_size=4),
                               st.dictionaries(st.text(max_size=8), children, max_size=5)),
    max_leaves=20)


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=st.dictionaries(st.text(max_size=8), _TREES, max_size=5))
def test_random_trees_match_flax(tree):
    ref = flax.serialization.msgpack_serialize(tree)
    assert msgpack_serialize(tree) == ref
    _assert_same(msgpack_restore(ref), flax.serialization.msgpack_restore(ref))


def test_chunked_form_round_trips_both_ways(monkeypatch):
    """Above MAX_CHUNK_SIZE bytes an array under dicts (not under lists) is
    split into chunks; patched small on both sides."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 16)
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((23, 3)).astype(np.float32),
            "n": {"small": np.arange(4, dtype=np.int8),
                  "big": rng.integers(0, 9, 40).astype(np.int64)},
            "in_list": [np.arange(30, dtype=np.float32)],
            "bf": jnp.asarray(rng.standard_normal(21), jnp.bfloat16)}
    ref = flax.serialization.msgpack_serialize(tree)
    assert msgpack_serialize(_port_form(tree)) == ref
    top = np.arange(10, dtype=np.float32)   # a top-level array is chunked too
    assert msgpack_serialize(top) == flax.serialization.msgpack_serialize(top)
    _assert_same(msgpack_restore(ref), flax.serialization.msgpack_restore(ref))
    _assert_same(msgpack_restore(msgpack_serialize(top)), top)
    back = flax.serialization.msgpack_restore(msgpack_serialize(_port_form(tree)))
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# ------------------------------------------------------------ files
def _model_trees():
    rng = np.random.default_rng(11)
    params = {"extractor": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                                     "bias": np.zeros(8, np.float32)}},
              "fc": {"kernel": rng.standard_normal((8, 14)).astype(np.float32),
                     "bias": rng.standard_normal(14).astype(np.float32)}}
    stats = {"extractor": {"bn": {"mean": rng.standard_normal(8).astype(np.float32),
                                  "var": rng.random(8).astype(np.float32)}}}
    return params, stats


def test_save_model_files_cross_both_ways(tmp_path):
    params, stats = _model_trees()
    extra = {"expert_refs": ["0123456789abcdef"], "expert_stats": [stats],
             "router": {}, "class_count": 14}
    jax_path, port_path = str(tmp_path / "j" / "m.msgpack"), str(tmp_path / "p" / "m.msgpack")
    jax_ckpt.save_model(jax_path, params, stats, extra=extra)
    n = checkpoint.save_model(port_path, params, stats, extra=extra)
    with open(jax_path, "rb") as f, open(port_path, "rb") as g:
        data = f.read()
        assert g.read() == data and n == len(data)
    _assert_same(checkpoint.load_model(jax_path), jax_ckpt.load_model(jax_path))
    _assert_same(jax_ckpt.load_model(port_path), jax_ckpt.load_model(jax_path))
    got = checkpoint.load_model(jax_path, {"params": params, "batch_stats": stats})
    assert set(got) == {"params", "batch_stats"}
    _assert_same(got["params"], jax_ckpt.load_model(jax_path)["params"])


def test_load_model_template_checks_keys_shapes_dtypes(tmp_path):
    params, stats = _model_trees()
    path = str(tmp_path / "m.msgpack")
    checkpoint.save_model(path, params, stats)
    bad_shape = {"fc": dict(params["fc"], kernel=np.zeros((8, 15), np.float32)),
                 "extractor": params["extractor"]}
    bad_dtype = {"fc": dict(params["fc"], bias=np.zeros(14, np.float64)),
                 "extractor": params["extractor"]}
    bad_keys = {"fc": params["fc"]}
    for template in (bad_shape, bad_dtype, bad_keys):
        with pytest.raises(ValueError):
            checkpoint.load_model(path, {"params": template, "batch_stats": stats})
    # torch leaves are templates too
    torch_template = {"fc": {n: torch.from_numpy(v) for n, v in params["fc"].items()},
                      "extractor": params["extractor"]}
    checkpoint.load_model(path, {"params": torch_template, "batch_stats": stats})


def _host_state():
    gen = np.random.default_rng(5)
    gen.random(3)
    return {"np_rng": gen.bit_generator.state, "memory_index": [np.arange(4)],
            "best_score": 12.5}


def test_train_state_files_cross_both_ways(tmp_path):
    params, stats = _model_trees()
    tx = optax.adam(1e-3)
    opt_state = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    rng_key = np.asarray(jax.random.PRNGKey(3))
    jax_path = jax_ckpt.train_state_path(str(tmp_path / "j"), "exp", "Latin", 1, 1)
    port_path = checkpoint.train_state_path(str(tmp_path / "p"), "exp", "Latin", 1, 1)
    assert port_path.endswith("exp/Latin_1_1_train_state.msgpack")
    assert os.path.relpath(port_path, tmp_path / "p") == os.path.relpath(jax_path, tmp_path / "j")
    jax_ckpt.save_train_state(jax_path, params=params, batch_stats=stats, opt_state=opt_state,
                              iteration=7, rng_key=rng_key, host_state=_host_state())
    got = checkpoint.load_train_state(jax_path)
    assert got["iteration"] == 7 and isinstance(got["iteration"], int)
    np.testing.assert_array_equal(got["rng_key"], rng_key)
    assert got["host_state"]["best_score"] == 12.5
    gen = np.random.default_rng()
    gen.bit_generator.state = got["host_state"]["np_rng"]
    ref_gen = np.random.default_rng(5)
    ref_gen.random(3)
    assert gen.random() == ref_gen.random()
    opt_sd = flax.serialization.to_state_dict(jax.device_get(opt_state))
    _assert_same(got["opt_state"], flax.serialization.msgpack_restore(
        flax.serialization.msgpack_serialize(opt_sd)))

    # the port writes the same bytes from the same content; JAX reads it
    checkpoint.save_train_state(port_path, params=params, batch_stats=stats,
                                opt_state=got["opt_state"], iteration=7, rng_key=rng_key,
                                host_state=_host_state())
    assert not os.path.exists(port_path + ".tmp")
    with open(jax_path, "rb") as f, open(port_path, "rb") as g:
        assert f.read() == g.read()
    back = jax_ckpt.load_train_state(port_path, opt_state_template=opt_state)
    assert back["iteration"] == 7
    for a, b in zip(jax.tree_util.tree_leaves(back["opt_state"]),
                    jax.tree_util.tree_leaves(opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert pickle.dumps(back["host_state"]) == pickle.dumps(_host_state())


def test_prune_and_merge_match_jax():
    tree = {"a": {"experts": {"w": 1}, "b": {"experts": 2, "c": 3}}, "experts": 4, "d": 5}
    assert checkpoint.prune_named_subtrees(tree, "experts") == \
        jax_ckpt.prune_named_subtrees(tree, "experts")
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    overlay = {"a": {"c": {"d": 9, "f": 1}}, "e": {"g": 1}}
    assert checkpoint.deep_merge(copy.deepcopy(base), overlay) == \
        jax_ckpt.deep_merge(copy.deepcopy(base), overlay)
