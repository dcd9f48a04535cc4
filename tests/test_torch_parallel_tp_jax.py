"""The port's model axis against the JAX package's on the CPU.

* ``make_param_specs``: the port's specs (torch name -> sharded torch dim),
  mapped to flax paths through the weight converters' layouts, equal
  JAX's ``make_param_specs`` leaf for leaf at ``n_model`` 2 and 3, on the
  JAX models' own full-size param trees (``WaveRNNConfig()`` and the
  full-size ``TacotronConfig``, shapes from ``jax.eval_shape`` of their
  ``init``, which must be the port's trees) and on the tree of
  ``tests/test_parallel.py::test_shard_params_tp_layout``.
* The deterministic scan ``Generator`` over a (data 4, model 2) local plan
  of ``["cpu"] * 8`` against JAX's ``Generator(mesh=make_mesh({"data": 4,
  "model": 2}))`` on the 8 virtual CPU devices of ``tests/conftest.py``,
  on ``tests/test_torch_parallel_jax.py``'s case, and byte-equal to the
  port's meshless Generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavernn_tpu.models.tacotron import Tacotron as JaxTacotron
from wavernn_tpu.models.tacotron import TacotronConfig as JaxTacotronConfig
from wavernn_tpu.models.wavernn import WaveRNN as JaxWaveRNN
from wavernn_tpu.models.wavernn import WaveRNNConfig as JaxConfig
from wavernn_tpu.ops.decode import Generator as JaxGenerator
from wavernn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from wavernn_tpu.parallel.mesh import make_param_specs as jax_param_specs
from wavernn_tpu_torch.models.tacotron import Tacotron, TacotronConfig
from wavernn_tpu_torch.models.wavernn import (
    WaveRNN, WaveRNNConfig, to_jax_variables,
)
from wavernn_tpu_torch.ops.decode import Generator
from wavernn_tpu_torch.parallel.mesh import make_mesh
from wavernn_tpu_torch.parallel.tensor_parallel import (
    make_param_specs, specs_from_layout,
)
from wavernn_tpu_torch.text.symbols import symbols
from wavernn_tpu_torch.training.state import layout_of
from tests.torch_cpu import one_torch_thread  # noqa: F401

VOC = dict(rnn_dims=32, fc_dims=32, bits=8, pad=2, upsample_factors=(2, 2),
           feat_dims=8, compute_dims=8, res_out_dims=8, res_blocks=1,
           hop_length=4, sample_rate=1000, mode="RAW")


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def as_spec(torch_dim, move):
    """A port spec as JAX's PartitionSpec string on the flax leaf."""
    if torch_dim is None:
        return "PartitionSpec()"
    flax_dim = 1 - torch_dim if move == "transpose" else torch_dim
    return ("PartitionSpec(None, 'model')" if flax_dim == 1
            else "PartitionSpec('model',)")


def port_specs_by_path(specs, layout):
    return {tuple(path): as_spec(specs[name], move)
            for name, path, move in layout}


@pytest.fixture(scope="module")
def full_models():
    """(port model, JAX param shapes) of the full-size vocoder and
    Tacotron."""
    cfg = JaxConfig()
    voc = jax.eval_shape(
        lambda k: JaxWaveRNN(cfg).init(
            k, jnp.zeros((1, cfg.hop_length)),
            jnp.zeros((1, 1 + 2 * cfg.pad, cfg.feat_dims)), True),
        jax.random.PRNGKey(0))["params"]
    tcfg = JaxTacotronConfig(num_chars=len(symbols))
    taco = jax.eval_shape(
        lambda k, d: JaxTacotron(tcfg).init(
            {"params": k, "dropout": d}, jnp.zeros((1, 16), jnp.int32),
            jnp.zeros((1, 4, tcfg.n_mels)), 2, True),
        jax.random.PRNGKey(0), jax.random.PRNGKey(1))["params"]
    return [(WaveRNN(WaveRNNConfig()), voc),
            (Tacotron(TacotronConfig(num_chars=len(symbols))), taco)]


@pytest.mark.parametrize("n_model", [2, 3])
def test_param_specs_match_jax_on_full_size_models(full_models, n_model):
    for model, shapes in full_models:
        layout = layout_of(model).params(model)
        params = dict(model.named_parameters())
        # the port's layout is the JAX model's own tree
        assert {tuple(p): tuple(np.transpose(params[n].detach().numpy(),
                                             (2, 1, 0)).shape
                                if m == "conv" else
                                params[n].T.shape if m == "transpose"
                                else params[n].shape)
                for n, p, m in layout} == {
                    k: tuple(v.shape) for k, v in flat(shapes).items()}
        want = {k: str(v) for k, v in
                flat(jax_param_specs(shapes, n_model)).items()}
        got = port_specs_by_path(make_param_specs(model, n_model), layout)
        assert got == want
        assert any("model" in s for s in got.values())


@pytest.mark.parametrize("n_model", [2, 3])
def test_param_specs_match_jax_on_the_layout_test_tree(n_model):
    """tests/test_parallel.py::test_shard_params_tp_layout's tree: a GRU
    cell's w_ih (64, 192) and b_ih, and a BatchNorm scale of 7."""
    tree = {"rnn": {"cell": {"w_ih": jnp.zeros((64, 192)),
                             "b_ih": jnp.zeros(192)}},
            "norm": {"scale": jnp.zeros(7)}}
    leaves = [(".".join(p), p, "copy", tuple(v.shape))
              for p, v in flat(tree).items()]
    want = {k: str(v) for k, v in
            flat(jax_param_specs(tree, n_model)).items()}
    got = port_specs_by_path(specs_from_layout(leaves, n_model),
                             [(n, p, m) for n, p, m, _ in leaves])
    assert got == want
    assert want[("rnn", "cell", "w_ih")] == "PartitionSpec(None, 'model')"
    assert want[("norm", "scale")] == "PartitionSpec()"


def test_generator_over_data_model_plan_matches_jax():
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        v = to_jax_variables(WaveRNN(WaveRNNConfig(**VOC)))
    mel = np.random.default_rng(3).uniform(0, 1, (8, 40)).astype(np.float32)
    geom = dict(batched=True, target=16, overlap=8, mu_law=True)
    want = JaxGenerator(JaxConfig(**VOC), v, backend="scan",
                        mesh=jax_make_mesh({"data": 4, "model": 2}),
                        deterministic=True)(mel, **geom)
    gen = Generator(WaveRNNConfig(**VOC), v, "cpu", backend="scan",
                    mesh=make_mesh({"data": 4, "model": 2},
                                   devices=["cpu"] * 8),
                    deterministic=True)
    got = gen(mel, **geom)
    plain = Generator(WaveRNNConfig(**VOC), v, "cpu", backend="scan",
                      deterministic=True)(mel, **geom)
    assert gen._pad_folds(3) == 4 and got.shape == want.shape
    assert np.std(want) > 0
    assert np.array_equal(got, plain)
    np.testing.assert_allclose(got, want, atol=1e-5)
