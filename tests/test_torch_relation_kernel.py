"""The relation-oracle kernel's module: plain version vs the JAX Pallas
kernel, and the wrapper's routing.

On the CPU the JAX ``rel_cache_pallas`` runs its Pallas kernel in interpret
mode, as ``tests/test_pallas_relation.py`` runs it. Tolerance: atol 1e-5
(float32 sums in another order). The CUDA kernel against the plain version,
on a card, is in ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfol_vqa_tpu.config import Config
from dfol_vqa_tpu.models import oracle as jom
from dfol_vqa_tpu.ops.pallas.relation_oracle import rel_cache_pallas
from dfol_vqa_tpu_torch import convert
from dfol_vqa_tpu_torch.models import oracle as om
from dfol_vqa_tpu_torch.ops import relation_oracle as ro

torch.backends.cuda.matmul.allow_tf32 = False


def cfg_with(relation_layers=(8,)) -> Config:
    return Config(box_features_dim=32, oracle_input_dim=16, word_embedding_dim=12,
                  featurizer_layers_config=[], attribute_network_layers_config=[8],
                  relation_network_layers_config=list(relation_layers), dropout=0.0)


def inputs(cfg, B, O, seed=0, R=4):
    rng = np.random.default_rng(seed)
    attr_in = rng.uniform(size=(B, O, cfg.attr_input_dim)).astype(np.float32)
    pos = rng.uniform(size=(B, O, 4)).astype(np.float32)
    tok = rng.integers(1, 2300, (B, R)).astype(np.int32)
    tok[0, R - 1] = 0  # pad slot
    return attr_in, pos, tok


@pytest.fixture(scope="module")
def params(ontology):
    jp = jom.init_oracle_params(jax.random.PRNGKey(0), cfg_with(), ontology)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("O", [7, 16])
def test_reference_matches_pallas_kernel(params, B, O):
    jp, tp = params
    cfg = cfg_with()
    attr_in, pos, tok = inputs(cfg, B, O, seed=B * 100 + O)
    want = rel_cache_pallas(jp, jnp.asarray(attr_in), jnp.asarray(pos), jnp.asarray(tok), cfg)
    got = ro.rel_cache_kernel_reference(tp, *map(torch.from_numpy, (attr_in, pos, tok)))
    assert got.shape == (B, 4, O, O)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert torch.all(got[0, 3] == om.DEFAULT_LOG_LIKELIHOOD)


def test_wrapper_on_cpu_takes_the_plain_version(params):
    _, tp = params
    cfg = cfg_with()
    ins = list(map(torch.from_numpy, inputs(cfg, 2, 5)))
    before = ro.LAUNCHES
    out = ro.rel_cache_kernel(tp, *ins, cfg)
    assert torch.equal(out, ro.rel_cache_kernel_reference(tp, *ins))
    assert ro.LAUNCHES == before  # the CUDA kernel never ran


def test_wrapper_routes_uncovered_shapes_to_rel_cache(ontology):
    """A 3-layer relation MLP is outside the kernel (as in rel_cache_pallas)."""
    cfg = cfg_with(relation_layers=(8, 8))
    jp = jom.init_oracle_params(jax.random.PRNGKey(1), cfg, ontology)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    ins = list(map(torch.from_numpy, inputs(cfg, 2, 5)))
    assert torch.equal(ro.rel_cache_kernel(tp, *ins, cfg), om.rel_cache(tp, *ins, cfg))


def test_interpreter_routes_cpu_to_plain_rel_cache(ontology):
    """On the CPU build_world takes oracle.rel_cache, whatever use_pallas says
    (as the JAX package does off the TPU)."""
    from dfol_vqa_tpu_torch.models.interpreter import Interpreter

    cfg = cfg_with()
    jp = jom.init_oracle_params(jax.random.PRNGKey(2), cfg, ontology)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(3)
    objs = np.concatenate([rng.standard_normal((2, 5, 32)), np.tile(
        [640, 480, 10, 20, 30, 40], (2, 5, 1)) * rng.uniform(0.5, 1, (2, 5, 6))], -1)
    objs = torch.from_numpy(objs.astype(np.float32))
    mask = torch.ones(2, 5)
    tok = torch.tensor([[3, 7], [0, 9]], dtype=torch.int32)
    world = Interpreter(cfg, ontology).build_world(tp, objs, mask, tok)
    assert torch.equal(world.rel_ll, om.rel_cache(tp, world.attr_in, world.pos, tok, cfg))
