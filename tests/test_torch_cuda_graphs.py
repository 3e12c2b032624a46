"""The trainer's chunk steps as CUDA graphs, on a card.

This file imports no JAX; on the GPU machine it runs without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py -q

Here, without a card, every test skips. At tiny widths (the demo training
and eval configs, dropout 0), over chunks of four batches and lone ones:

* a training chunk or a lone step replayed from its graph leaves the
  parameters and Adam's state where the eager path from the same state
  leaves them (each leaf's change within 3e-4 of its largest change, the
  chip smoke's ``TRAIN_GRAD_RTOL``; the losses within 1e-5 relative), for
  the first group (eager), the second (captured, then replayed) and the
  third (replayed), with ``pad_chunks`` on and off (the port pads
  nothing); under ``pad_chunks`` a short group's graph runs its real steps
  only;
* a lone step of the calibrator configuration at dropout 0.1, from one
  state and one seed, gives the eager step's loss when warm, captured and
  replayed; two replays from one state without a new seed draw different
  masks;
* an evaluation chunk replayed from its graph gives the eager forwards'
  answer flags and matches, log-probabilities within 1e-6; evaluating
  another parameter tree drops the eval graphs of the last one;
* a capture that fails raises, and the key is not left half made;
* the kernels' launch counts include the launches of every replay.
"""

import copy
import dataclasses

import pytest
import torch

from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.data.transfer import chunk_prefetch
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.train import graphs
from dfol_vqa_tpu_torch.train.graphs import GraphCache
from dfol_vqa_tpu_torch.train.optim import Optimizer
from dfol_vqa_tpu_torch.train.trainer import VQATrainer

torch.backends.cuda.matmul.allow_tf32 = False
UPDATE_RTOL = 3e-4
CHUNK = 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def ontology():
    return GQAOntology()


def train_groups(ontology, n_chunks, tail=0, chunk=CHUNK, cfg=None):
    """``n_chunks`` full groups of ``chunk`` batches of one ``exist`` file
    (the per-question route at tiny widths), then a group of ``tail``
    batches; ``cfg`` the demo training config by default."""
    cfg = cfg or trainset.demo_train_config(tiny=True)
    cfg.tpu.train_chunk = CHUNK
    world = evalset.demo_world(ontology, tiny=True)
    n = n_chunks * chunk + tail
    files = trainset.train_datasets(world, (("exist", 2, n * trainset.TINY_BATCH),), seed=3)
    loader = trainset.train_loader(cfg, ontology, world, files, seed=2)
    groups = list(chunk_prefetch(loader, chunk, "cuda"))
    assert [len(g[0]) for g in groups] == [chunk] * n_chunks + ([tail] if tail else [])
    return cfg, groups


def state_of(params, opt):
    return [t.detach().clone() for t in list(params.parameters()) + opt._state_tensors()]


def assert_updates_close(got, want, start):
    for g, w, s in zip(got, want, start):
        scale = float((w.double() - s.double()).abs().max())
        err = float((g.double() - w.double()).abs().max())
        assert err <= UPDATE_RTOL * max(scale, 1e-30) or err == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, CHUNK])
@pytest.mark.parametrize("pad", [True, False])
def test_train_chunk_replay_equals_eager(cuda, ontology, pad, n):
    """Three groups of ``n`` batches (one key): eager, captured and
    replayed, replayed; no group is padded."""
    cfg, groups = train_groups(ontology, 3, chunk=n)
    cfg.tpu.pad_chunks = pad
    params = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0), cuda)
    sides = []
    for capture in (True, False):
        p = copy.deepcopy(params)
        trainer = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
        trainer.graphs = GraphCache(cuda, capture=capture)
        opt = Optimizer(cfg, p)
        opt.static_grads()
        sides.append((trainer, p, opt))
    for k, (group, objects, obj_mask, arrays) in enumerate(groups):
        start = state_of(sides[1][1], sides[1][2])
        losses = [t._train_chunk(p, opt, group, objects, obj_mask, arrays, None)
                  for t, p, opt in sides]
        assert losses[0].shape == losses[1].shape == (n,)
        torch.testing.assert_close(losses[0], losses[1], rtol=1e-5, atol=0)
        assert_updates_close(state_of(*sides[0][1:]), state_of(*sides[1][1:]), start)
    stats = sides[0][0].graphs.stats()
    assert stats["graphs"] == 1 and stats["replays"] == 2
    assert sides[1][0].graphs.stats()["graphs"] == 0


@pytest.mark.cuda
def test_lone_calibrator_steps_at_dropout_replay_new_masks(cuda, ontology):
    """The calibrator configuration (state 8) at dropout 0.1, one lone
    group: three runs from one state with the generator seeded alike (warm,
    captured and replayed, replayed) each give the loss of the eager step
    from that state and seed; two more replays from that state, the
    generator going on, draw different masks."""
    cfg = dataclasses.replace(trainset.demo_train_config(tiny=True), dropout=0.1,
                              activate_attention_transfer=True,
                              attention_transfer_state_dim=8)
    cfg, ((group, objects, obj_mask, arrays),) = train_groups(ontology, 1, chunk=1, cfg=cfg)
    params = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0), cuda)
    assert params.calibrator is not None
    sides = []
    for capture in (True, False):
        trainer = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
        trainer.graphs = GraphCache(cuda, capture=capture)
        p = copy.deepcopy(params)
        opt = Optimizer(cfg, p)
        opt.static_grads()
        sides.append((trainer, p, opt, torch.Generator(device=cuda)))
    starts = [state_of(p, opt) for _, p, opt, _ in sides]

    def run(side, start, seed=None):
        trainer, p, opt, gen = side
        with torch.no_grad():
            for t, s in zip(list(p.parameters()) + opt._state_tensors(), start):
                t.copy_(s)
        if seed is not None:
            gen.manual_seed(seed)
        return trainer._train_chunk(p, opt, group, objects, obj_mask, arrays, gen)

    want = run(sides[1], starts[1], seed=0)
    routes = []
    for _ in range(3):
        torch.testing.assert_close(run(sides[0], starts[0], seed=0), want, rtol=1e-5, atol=0)
        routes.append(sides[0][0].graphs.last_route)
    assert routes == ["warm", "capture", "replay"]
    first, second = run(sides[0], starts[0]), run(sides[0], starts[0])
    assert torch.isfinite(first).all() and not torch.equal(first, second)


@pytest.mark.cuda
def test_padded_steps_change_nothing_in_a_graph(cuda, ontology):
    """Three groups of two batches at ``train_chunk=4`` with
    ``pad_chunks``: the graph runs the two real steps only, so after each
    replay the state equals two eager steps' within the gate, and Adam's
    step count grows by two a chunk."""
    cfg = trainset.demo_train_config(tiny=True)
    cfg.tpu.train_chunk = 2
    world = evalset.demo_world(ontology, tiny=True)
    files = trainset.train_datasets(world, (("exist", 2, 6 * trainset.TINY_BATCH),), seed=3)
    groups = list(chunk_prefetch(trainset.train_loader(cfg, ontology, world, files, seed=2), 2,
                                 cuda))
    cfg.tpu.train_chunk = CHUNK  # each group of two, short of the chunk
    params = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0), cuda)
    trainer = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
    eager = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
    eager.graphs = GraphCache(cuda, capture=False)
    p2 = copy.deepcopy(params)
    opt, opt2 = Optimizer(cfg, params), Optimizer(cfg, p2)
    for k, (group, objects, obj_mask, arrays) in enumerate(groups):
        start = state_of(p2, opt2)
        trainer._train_chunk(params, opt, group, objects, obj_mask, arrays, None)
        for i, b in enumerate(group):
            eager._grads(p2, objects[i], obj_mask[i], {n: v[i] for n, v in arrays.items()},
                         b.spec)
            opt2.step()
        assert_updates_close(state_of(params, opt), state_of(p2, opt2), start)
        assert float(opt.adam.state[opt.trainable[0]]["step"]) == 2.0 * (k + 1)
    assert trainer.graphs.stats()["replays"] == len(groups) - 1


@pytest.mark.cuda
def test_eval_chunk_replay_equals_eager(cuda, ontology):
    cfg = evalset.demo_eval_config(tiny=True, stream_dtype="float32")
    cfg.tpu.eval_chunk = CHUNK
    world = evalset.demo_world(ontology, tiny=True)
    files = evalset.eval_datasets(world, (("exist", 2, 64), ("verify_rel", 1, 48)),
                                  evalset.TINY_BATCH, evalset.TINY_IMAGES_PER_BATCH, seed=6)
    params = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0), cuda)
    graphed = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
    eager = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
    eager.graphs = GraphCache(cuda, capture=False)
    want = list(eager._eval_chunked(evalset.eval_loader(cfg, ontology, world, files), params))
    for _ in range(3):  # eager warm-up, capture + replay, replay
        got = list(graphed._eval_chunked(evalset.eval_loader(cfg, ontology, world, files),
                                         params))
        assert len(got) == len(want) == 7
        for (_, g), (_, w) in zip(got, want):
            assert torch.equal(g["answer_flags"], w["answer_flags"])
            assert torch.equal(g["match"], w["match"])
            torch.testing.assert_close(g["log_probability"], w["log_probability"], atol=1e-6,
                                       rtol=0)
    stats = graphed.graphs.stats()
    assert stats["graphs"] == 2 and stats["replays"] == 4


@pytest.mark.cuda
def test_eval_graphs_follow_the_parameter_tree(cuda, ontology):
    """Evaluating a second tree drops the first tree's graphs and reads the
    second tree's values; the trainer holds the tree its graphs read."""
    cfg = evalset.demo_eval_config(tiny=True, stream_dtype="float32")
    cfg.tpu.eval_chunk = CHUNK
    world = evalset.demo_world(ontology, tiny=True)
    files = evalset.eval_datasets(world, (("exist", 2, 64),), evalset.TINY_BATCH,
                                  evalset.TINY_IMAGES_PER_BATCH, seed=6)
    interp = Interpreter(cfg, ontology)
    trees = [interp.init_params(torch.Generator().manual_seed(s), cuda) for s in (0, 1)]
    graphed = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
    eager = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
    eager.graphs = GraphCache(cuda, capture=False)
    for params in trees:
        want = [o["log_probability"] for _, o in eager._eval_chunked(
            evalset.eval_loader(cfg, ontology, world, files), params)]
        for _ in range(3):
            got = [o["log_probability"] for _, o in graphed._eval_chunked(
                evalset.eval_loader(cfg, ontology, world, files), params)]
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
        stats = graphed.graphs.stats()
        assert stats["graphs"] == 1 and stats["replays"] == 2
        assert graphed._eval_params[0] is params


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    cache = GraphCache(cuda)
    x = torch.ones(4, device=cuda)

    def reads_the_host(t):
        return (t * float(t.sum().item()),)  # a host read cannot be captured

    assert torch.equal(cache.run(("eval", "k"), reads_the_host, [x])[0], x * 4)
    with pytest.raises(RuntimeError):
        cache.run(("eval", "k"), reads_the_host, [x])
    assert cache.stats()["graphs"] == 0
    torch.cuda.synchronize()
    # the key starts over: warm-up, then the same failure again
    assert torch.equal(cache.run(("eval", "k"), reads_the_host, [x])[0], x * 4)


@pytest.mark.cuda
def test_launch_counts_include_replays(cuda, ontology):
    from dfol_vqa_tpu_torch.ops import relation_oracle as ro

    cfg, groups = train_groups(ontology, 3)
    params = Interpreter(cfg, ontology).init_params(torch.Generator().manual_seed(0), cuda)
    trainer = VQATrainer(cfg, Interpreter(cfg, ontology), device=cuda)
    opt = Optimizer(cfg, params)
    opt.static_grads()
    counts = []
    for group, objects, obj_mask, arrays in groups:
        before = (ro.LAUNCHES, ro.BWD_LAUNCHES)
        trainer._train_chunk(params, opt, group, objects, obj_mask, arrays, None)
        torch.cuda.synchronize()
        counts.append((ro.LAUNCHES - before[0], ro.BWD_LAUNCHES - before[1]))
    assert counts == [(CHUNK, CHUNK)] * 3  # eager, captured + replayed, replayed
    graph, = trainer.graphs.graphs
    assert graph.launches == [CHUNK, CHUNK, 0, 0] and graph.replays == 2
    assert graphs.launch_counts()[:2] == [ro.LAUNCHES, ro.BWD_LAUNCHES]
