"""The trainer's lone training steps go through its graph cache (CPU).

* A group of one batch runs through ``GraphCache.run`` under a "train" key
  with chunk length 1, unpadded also under ``pad_chunks``, and its losses,
  parameters and Adam state equal, bitwise, those of the one-step path it
  replaced (``_grads``, then ``opt.step()``) from the same state, at
  dropout 0.1 from generators seeded alike;
* the lone ``train.step`` span's ``route`` is the cache's ``last_route``:
  a cache that reports "replay" gives "replay", for the chunk's span too;
* under a mesh the steps do not go through the cache, and their spans say
  "eager".
"""

import copy

import pytest
import torch

from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import chunk_prefetch
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.train.graphs import GraphCache
from dfol_vqa_tpu_torch.train.optim import Optimizer
from dfol_vqa_tpu_torch.train.trainer import VQATrainer
from dfol_vqa_tpu_torch.utils import profiling

CHUNK = 4


class Recording(GraphCache):
    """The CPU cache (it calls ``fn``), recording each key and reporting
    ``route`` as the route it took."""

    def __init__(self, route: str = "eager"):
        super().__init__("cpu")
        self.keys, self.route = [], route

    def run(self, key, fn, inputs, generator=None):
        self.keys.append(key)
        out = super().run(key, fn, inputs, generator)
        self.last_route = self.route
        return out


@pytest.fixture(scope="module")
def ontology():
    return GQAOntology()


def tiny(ontology, n_batches, pad=False, dropout=0.0):
    """(cfg, loader, params) at tiny widths: one ``exist`` file of
    ``n_batches`` batches, ``train_chunk`` 4."""
    cfg = trainset.demo_train_config(tiny=True)
    cfg.epoch_num = 1
    cfg.dropout = dropout
    cfg.tpu.train_chunk = CHUNK
    cfg.tpu.pad_chunks = pad
    world = evalset.demo_world(ontology, tiny=True)
    files = trainset.train_datasets(world, (("exist", 2, n_batches * trainset.TINY_BATCH),),
                                    seed=5)
    loader = trainset.train_loader(cfg, ontology, world, files, seed=1)
    params = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0),
                                                    torch.device("cpu"))
    return cfg, loader, params


def state_of(params, opt):
    return [t.detach().clone() for t in list(params.parameters()) + opt._state_tensors()]


@pytest.mark.parametrize("pad", [False, True])
def test_a_lone_group_runs_through_the_cache_unpadded_as_before(ontology, pad):
    cfg, loader, params = tiny(ontology, 3, pad=pad, dropout=0.1)
    groups = list(chunk_prefetch(loader, 1, "cpu"))
    assert [len(g[0]) for g in groups] == [1, 1, 1]
    trainer = VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu")
    trainer.graphs = Recording()
    before = copy.deepcopy(params)
    opt, opt_before = Optimizer(cfg, params), Optimizer(cfg, before)
    gen = torch.Generator().manual_seed(7)
    gen_before = torch.Generator().manual_seed(7)
    for group, objects, obj_mask, arrays in groups:
        losses = trainer._train_chunk(params, opt, group, objects, obj_mask, arrays, gen)
        # the one-step path before lone steps went through the cache
        loss = trainer._grads(before, objects[0], obj_mask[0],
                              {k: v[0] for k, v in arrays.items()}, group[0].spec, gen_before)
        opt_before.step()
        assert losses.shape == (1,) and torch.equal(losses[0], loss)
        for a, b in zip(state_of(params, opt), state_of(before, opt_before)):
            assert torch.equal(a, b)
    assert float(opt.adam.state[opt.trainable[0]]["step"]) == 3.0
    assert torch.equal(gen.get_state(), gen_before.get_state())
    assert len(trainer.graphs.keys) == 3
    for key, (group, *_) in zip(trainer.graphs.keys, groups):
        kind, spec, meta, shapes, k = key[:5]
        assert (kind, spec, meta, k) == ("train", group[0].spec, group[0].meta, 1)
        assert all(shape[0] == 1 for shape, _ in shapes)


def lone_and_chunk_spans(ontology, cache):
    """``train`` over five batches of one bucket (groups of 4 and 1) with
    ``cache`` as the trainer's graph cache: the ``train.step`` spans'
    tags."""
    cfg, loader, params = tiny(ontology, 5)
    trainer = VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu")
    trainer.graphs = cache
    profiling.clear()
    trainer.train(loader, None, params)
    return [r[4] for r in profiling.recorded() if r[0] == "train.step"]


@pytest.mark.parametrize("route", ["eager", "replay"])
def test_the_lone_steps_span_takes_the_caches_route(ontology, route):
    cache = Recording(route)
    tags = lone_and_chunk_spans(ontology, cache)
    assert [(t["steps"], t["route"]) for t in tags] == [(4, route), (1, route)]
    assert [key[4] for key in cache.keys] == [4, 1]


def test_the_mesh_path_tags_eager_and_skips_the_cache(ontology):
    """The mesh branch, its lockstep groups and step stubbed (no process
    group here): each step is its own ``train.step`` span, tagged "eager"
    whatever the cache last reported, and nothing goes through the
    cache."""
    cfg, loader, params = tiny(ontology, 3)
    trainer = VQATrainer(cfg, Interpreter(cfg, ontology), device="cpu")
    trainer.graphs = Recording("replay")
    trainer.graphs.last_route = "replay"
    trainer.mesh = object()
    batches = list(loader)
    trainer.mesh_groups = lambda loader, chunk: iter([[(b, b.batch_size) for b in batches[:2]],
                                                      [(batches[2], batches[2].batch_size)]])
    taken = []

    def train_step(state, opt, batch, generator, count):
        taken.append(batch)
        return torch.zeros(())

    trainer.train_step = train_step
    profiling.clear()
    out = list(trainer._train_groups(None, params, None, None))
    assert [len(losses) for losses, _ in out] == [2, 1]
    assert len(taken) == 3 and all(a is b for a, b in zip(taken, batches))
    tags = [r[4] for r in profiling.recorded() if r[0] == "train.step"]
    assert [(t["steps"], t["route"]) for t in tags] == [(1, "eager")] * 3
    assert trainer.graphs.keys == []
