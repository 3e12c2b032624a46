"""The port's span recorder (``dfol_vqa_tpu_torch.utils.profiling``) and
the spans of its training path, on the CPU.

* ``span`` on a worker thread is recorded with that thread's ident and its
  tags, including a tag set inside the block;
* the ring keeps its bound, dropping the oldest spans;
* under ``profile_trace`` (every thread) a span on a worker thread is a
  ``dfol.*`` event of that thread in the exported ``trace.json``, and its
  interval from the recorder, put on the trace's clock by
  ``trace_to_perf_ns``, matches the event's within 0.1 ms;
* a tiny ``VQATrainer.train`` over five batches of one bucket at
  ``train_chunk=4`` (groups of 4 and 1): per group one ``train.step`` (its
  ``steps``, route "eager" on the CPU) and one ``transfer.wait`` on the
  trainer's thread (and one more that meets the end of the epoch), a
  ``transfer.stage`` per group on the thread that copies it (the
  transfer worker for 4 batches, the trainer for 1), one ``train.readback``,
  and per batch one ``loader.programs``, ``loader.scenes`` and
  ``loader.batch`` on the loader's producer thread, in that order;
* ``GraphCache.last_route`` is "eager" where nothing is captured.
"""

import json
import threading
import time

import torch

from dfol_vqa_tpu_torch.data import evalset, trainset
from dfol_vqa_tpu_torch.models.interpreter import Interpreter
from dfol_vqa_tpu_torch.ontology import GQAOntology
from dfol_vqa_tpu_torch.train.graphs import GraphCache
from dfol_vqa_tpu_torch.train.trainer import VQATrainer
from dfol_vqa_tpu_torch.utils import profiling

MAP_TOL_NS = 100_000  # 0.1 ms


def _on_thread(fn):
    out = {}

    def run():
        out["ident"], out["native"] = threading.get_ident(), threading.get_native_id()
        fn()

    t = threading.Thread(target=run)
    t.start()
    t.join()
    return out


def test_span_on_a_worker_thread_is_recorded_with_its_thread():
    profiling.clear()

    def work():
        with profiling.span("test.worker", batches=3) as s:
            time.sleep(0.001)
            s.tags["route"] = "eager"

    who = _on_thread(work)
    (name, thread, start, end, tags), = [r for r in profiling.recorded()
                                         if r[0] == "test.worker"]
    assert thread == who["ident"] != threading.get_ident()
    assert end - start >= 1_000_000 and tags == {"batches": 3, "route": "eager"}


def test_the_ring_keeps_its_bound():
    profiling.clear()
    for i in range(profiling.RING_SIZE + 5):
        with profiling.span("test.ring", i=i):
            pass
    got = profiling.recorded()
    assert len(got) == profiling.RING_SIZE
    assert got[0][4] == {"i": 5} and got[-1][4] == {"i": profiling.RING_SIZE + 4}
    profiling.clear()
    assert profiling.recorded() == []


def test_a_worker_span_is_in_the_trace_on_the_recorders_clock(tmp_path):
    profiling.clear()

    def work():
        for i in range(3):
            with profiling.span(f"test.mapped{i}"):
                torch.ones((64, 64)) @ torch.ones((64, 64))
                time.sleep(0.002)

    with profiling.profile_trace(str(tmp_path / "prof")):
        who = _on_thread(work)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("dfol.test.mapped")}
    spans = [r for r in profiling.recorded() if r[0].startswith("test.mapped")]
    assert len(spans) == 3 and {r[1] for r in spans} == {who["ident"]}
    for name, _, start, end, _ in spans:
        e = events["dfol." + name]
        assert e["tid"] == who["native"]
        s = profiling.trace_to_perf_ns(e["ts"], trace["baseTimeNanoseconds"])
        t = profiling.trace_to_perf_ns(e["ts"] + e["dur"], trace["baseTimeNanoseconds"])
        assert abs(s - start) <= MAP_TOL_NS and abs(t - end) <= MAP_TOL_NS, (s - start, t - end)
        # the exporter's base is the one trace_to_perf_ns takes by default
        assert abs(profiling.trace_to_perf_ns(e["ts"]) - s) <= MAP_TOL_NS


def test_graph_cache_reports_the_eager_route():
    cache = GraphCache("cpu")
    assert cache.last_route is None
    assert cache.run(("train", 1), lambda x: (x + 1,), [torch.zeros(2)])[0].tolist() == [1, 1]
    assert cache.last_route == "eager"


def test_training_records_its_spans_per_group_and_batch():
    ont = GQAOntology()
    cfg = trainset.demo_train_config(tiny=True)
    cfg.epoch_num = 1
    cfg.tpu.train_chunk = 4
    world = evalset.demo_world(ont, tiny=True)
    files = trainset.train_datasets(world, (("exist", 2, 5 * trainset.TINY_BATCH),), seed=5)
    loader = trainset.train_loader(cfg, ont, world, files, seed=1)
    interp = Interpreter(cfg, ont)
    params = interp.init_params(torch.Generator().manual_seed(0), torch.device("cpu"))
    profiling.clear()
    VQATrainer(cfg, interp, device="cpu").train(loader, None, params)
    rec = profiling.recorded()
    me = threading.get_ident()

    def of(name):
        return [r for r in rec if r[0] == name]

    steps = of("train.step")
    elems = {"grad_elems": sum(p.numel() for p in params.parameters() if p.requires_grad),
             "param_elems": sum(p.numel() for p in params.parameters())}
    assert elems["grad_elems"] == elems["param_elems"] > 0  # every leaf trains
    assert [(r[1], r[4]) for r in steps] == [(me, {"steps": 4, "route": "eager", **elems}),
                                              (me, {"steps": 1, "route": "eager", **elems})]
    waits = of("transfer.wait")
    assert len(waits) == len(steps) + 1 and {r[1] for r in waits} == {me}
    # each group's wait ends before its step starts
    assert all(w[3] <= s[2] for w, s in zip(waits, steps))
    stages = of("transfer.stage")
    assert [r[4]["batches"] for r in stages] == [4, 1]
    assert stages[0][1] != me and stages[1][1] == me
    assert len(of("train.readback")) == 1 and of("train.readback")[0][1] == me
    names = [r[0] for r in rec if r[0].startswith("loader.")]
    assert names == ["loader.programs", "loader.scenes", "loader.batch"] * 5
    producers = {r[1] for r in rec if r[0].startswith("loader.")}
    assert len(producers) == 1 and not producers & {me, stages[0][1]}
    for r in rec:
        assert r[3] >= r[2]
