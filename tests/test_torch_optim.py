"""The port's optimizers against optax (the JAX package's
``build_optimizer``: clip by global norm, then SGD with decayed weights and
momentum, Adadelta or Adam), float32 on the CPU: five steps of the same
gradients, under, over and near the clip norm; the state written in
optax's layout loads into ``tx.init`` of the JAX optimizer and back; and
DER's freezing, the old extractors left out of the optimizer, updates as
JAX's zeroed gradients of the stacked leaves do."""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.train.learners.der import DER as JaxDER
from mrn_tpu.train.optim import build_optimizer as jax_build_optimizer
from mrn_tpu.train.optim import build_schedule as jax_build_schedule
from mrn_tpu_torch.bridge import from_flax
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.train.optim import (Adadelta, Adam, SGD, build_optimizer, build_schedule,
                                       opt_state_from_optax, opt_state_to_optax)

NAMES = ["fc.kernel", "fc.bias", "extractor.seq_linear.kernel"]
SHAPES = [(6, 5), (5,), (4, 6)]
SCALES = (0.1, 10.0, 1.0, 3.0, 0.5)   # gradient scales: under, over, near the norm 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(values):
    """Port-named arrays as a flax-layout dict (jnp leaves)."""
    out = {}
    for name, v in zip(NAMES, values):
        *heads, last = name.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
    return out


def _flat(tree):
    state = from_flax(jax.tree_util.tree_map(np.asarray, tree))
    return [state[n].numpy() for n in NAMES]


def _pair(name, params):
    """(the port's optimizer, optax's tx and state) of ``name`` over
    ``params``."""
    kw = dict(optimizer=name, num_iter=8, sgd_weight_decay=1e-2)
    opt, jopt = default_options(**kw), jax_options(**kw)
    port = build_optimizer(opt, build_schedule(opt), [torch.from_numpy(p.copy()) for p in params])
    tree = _tree(params)
    tx = jax_build_optimizer(jopt, jax_build_schedule(jopt),
                             jax.tree_util.tree_map(lambda _: True, tree))
    return port, tx, tx.init(tree), tree


@pytest.mark.parametrize("name", ["sgd", "adadelta", "adam"])
def test_optimizer_matches_optax(rng, name):
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    port, tx, state, tree = _pair(name, params)
    assert type(port) is {"sgd": SGD, "adadelta": Adadelta, "adam": Adam}[name]
    for scale in SCALES:
        grads = [scale * rng.standard_normal(s).astype(np.float32) for s in SHAPES]
        updates, state = tx.update(_tree(grads), state, tree)
        tree = optax.apply_updates(tree, updates)
        info = port.step([torch.from_numpy(g) for g in grads])
        norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads))
        np.testing.assert_allclose(float(info["grad_norm"]), norm, rtol=1e-5)
        for got, ref in zip(port.params, _flat(tree)):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-7, rtol=1e-6)
    assert port.count == len(SCALES)


@pytest.mark.parametrize("name", ["sgd", "adadelta", "adam"])
def test_state_layout_round_trip_through_tx_init(rng, name):
    """Two steps, then the state in optax's layout: it restores into the
    JAX optimizer's ``tx.init`` state (every leaf, the counts) and loads
    back into a fresh port optimizer bitwise."""
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    port, tx, template, tree = _pair(name, params)
    for scale in SCALES[:2]:
        port.step([torch.from_numpy(scale * rng.standard_normal(s).astype(np.float32))
                   for s in SHAPES])
    payload = opt_state_to_optax(port, NAMES)
    restored = flax.serialization.from_state_dict(template, payload)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)
    for leaf in jax.tree_util.tree_leaves(restored):
        if np.ndim(leaf) == 0:
            assert int(leaf) == 2
    moments = [np.asarray(x) for x in jax.tree_util.tree_leaves(restored) if np.ndim(x) > 0]
    assert len(moments) == len(port.MOMENTS) * len(NAMES)
    fresh, _, _, _ = _pair(name, params)
    opt_state_from_optax(fresh, NAMES, flax.serialization.to_state_dict(restored))
    assert fresh.count == 2
    for key in port.MOMENTS:
        for a, b in zip(getattr(port, key), getattr(fresh, key)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        opt_state_from_optax(fresh, NAMES[:2], payload)


@pytest.mark.parametrize("name", ["adam", "adadelta"])
def test_der_frozen_extractors_out_of_the_optimizer_equal_jax_zeroed_grads(rng, name):
    """Two stacked extractors (the first frozen) and an fc: three steps of
    optax over the whole tree with DER's ``grad_transform`` (zeroing the
    old slice) against the port's optimizer over the newest extractor and
    the fc only.  The frozen slice stays put, the rest moves alike, and the
    snapshot of the port's state (frozen moments zero) loads into
    ``tx.init``."""
    kw = dict(optimizer=name, num_iter=8)
    opt, jopt = default_options(**kw), jax_options(**kw)
    stack = rng.standard_normal((2, 4, 6)).astype(np.float32)
    fc = rng.standard_normal((12, 5)).astype(np.float32)
    tree = {"extractors": {"seq_linear": {"kernel": jnp.asarray(stack)}},
            "fc": {"kernel": jnp.asarray(fc)}}
    stub = JaxDER.__new__(JaxDER)
    stub.n_experts = 2
    mask = JaxDER.grad_transform(stub)
    tx = jax_build_optimizer(jopt, jax_build_schedule(jopt),
                             jax.tree_util.tree_map(lambda _: True, tree))
    state = tx.init(tree)
    live = {"extractors.1.seq_linear.kernel": torch.from_numpy(stack[1].copy()),
            "fc.kernel": torch.from_numpy(fc.copy())}
    port = build_optimizer(opt, build_schedule(opt), list(live.values()))
    for scale in (0.3, 20.0, 1.0):
        g_stack = scale * rng.standard_normal(stack.shape).astype(np.float32)
        g_fc = scale * rng.standard_normal(fc.shape).astype(np.float32)
        grads = mask({"extractors": {"seq_linear": {"kernel": jnp.asarray(g_stack)}},
                      "fc": {"kernel": jnp.asarray(g_fc)}})
        updates, state = tx.update(grads, state, tree)
        tree = optax.apply_updates(tree, updates)
        port.step([torch.from_numpy(g_stack[1]), torch.from_numpy(g_fc)])
    ref_stack = np.asarray(tree["extractors"]["seq_linear"]["kernel"])
    np.testing.assert_array_equal(ref_stack[0], stack[0])
    np.testing.assert_allclose(live["extractors.1.seq_linear.kernel"].numpy(), ref_stack[1],
                               atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(live["fc.kernel"].numpy(), np.asarray(tree["fc"]["kernel"]),
                               atol=1e-7, rtol=1e-6)
    frozen = {"extractors.0.seq_linear.kernel": torch.from_numpy(stack[0])}
    payload = opt_state_to_optax(port, list(live), frozen)
    restored = flax.serialization.from_state_dict(tx.init(tree), payload)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(state)
    for got, ref in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-9, rtol=1e-5)
    fresh = build_optimizer(opt, build_schedule(opt), [torch.zeros_like(t) for t in live.values()])
    opt_state_from_optax(fresh, list(live), payload, frozen=list(frozen))
    assert fresh.count == 3
