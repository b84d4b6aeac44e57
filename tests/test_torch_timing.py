"""The port's tracer (``repro_torch.utils.timing``): off it records nothing;
on it links each span to its parent and carries the step or trigger it
belongs to, also to work that ends on another thread; its buffer is
bounded and counts what it drops; on the thread that enabled it, its
spans are on ``torch.profiler``'s timeline; and over a trainer's job (steps,
fulls, deltas, a restore from memory) every span of the step, the
checkpoint plane and the restore appears under its step or trigger, and
each save and the restore hold their parts, in order."""
import threading

import pytest
import torch

from repro_torch.utils import timing
from repro_torch.utils.timing import OFF, Tracer


@pytest.fixture
def tracer():
    t = Tracer()
    t.enable()
    yield t
    t.disable()


def test_off_records_nothing_and_returns_one_shared_object():
    t = Tracer()
    a, b = t.span("x", step=1), t.span("y")
    assert a is b is OFF
    with a as s:
        s.set(bytes=4)
    assert t.pending("z", 3) is OFF
    OFF.done()
    assert t.spans() == [] and t.dropped == 0
    # the program's tracer is off unless something turns it on
    assert not timing.enabled()
    assert timing.span("trainer.step", step=1) is OFF


def test_parents_and_step_ids_hold_across_nesting(tracer):
    with tracer.span("trainer.step", step=7) as step:
        with tracer.span("train.grad") as grad:
            with tracer.span("inner", step=99) as inner:
                pass
        with tracer.span("train.optim") as optim:
            optim.set(passes=15)
    with tracer.span("ckpt.save", step=8) as save:
        save.set(kind="delta")
        with tracer.span("ckpt.delta.pack") as pack:
            pass
    with tracer.span("data.batch") as batch:
        pass
    ends = [s.name for s in tracer.spans()]
    assert ends == ["inner", "train.grad", "train.optim", "trainer.step",
                    "ckpt.delta.pack", "ckpt.save", "data.batch"]
    assert step.parent is None and batch.parent is None
    assert grad.parent == step.id and optim.parent == step.id
    assert inner.parent == grad.id
    assert grad.attrs == {"step": 7} and inner.attrs == {"step": 99}
    assert optim.attrs == {"step": 7, "passes": 15}
    assert pack.parent == save.id
    assert pack.attrs == {"step": 8, "kind": "delta"}
    assert "step" not in batch.attrs
    for s in tracer.spans():
        assert s.start <= s.end and s.thread == "MainThread"
    assert grad.start >= step.start and grad.end <= optim.start
    assert optim.end <= step.end
    d = grad.as_dict()
    assert d["name"] == "train.grad" and d["parent"] == step.id


def test_allocator_retries_are_counted_on_cuda_only(tracer):
    assert timing.alloc_retries("cpu") is None
    with tracer.span("trainer.step", retries_of=torch.device("cpu"),
                     step=1) as s:
        pass
    assert s.attrs == {"step": 1}       # no CUDA allocator to read
    if torch.cuda.is_available():
        with tracer.span("trainer.step", retries_of="cuda", step=2) as s:
            torch.empty(1024, device="cuda")
        assert s.attrs["alloc_retries"] >= 0


def test_an_exception_closes_the_span_and_unwinds_the_stack(tracer):
    with pytest.raises(ValueError):
        with tracer.span("outer", step=1):
            with tracer.span("inner"):
                raise ValueError
    assert [s.name for s in tracer.spans()] == ["inner", "outer"]
    assert tracer.current() is None


def test_a_background_span_carries_its_triggers_step(tracer):
    """Work queued under a trigger's span and finished on other threads
    makes ONE span, ended by the last part, with the trigger's step and
    kind and the queueing span as its parent."""
    with tracer.span("ckpt.save", step=12, kind="full") as save:
        landed = tracer.pending("ckpt.d2h.background", 3)
        threads = [threading.Thread(target=landed.done,
                                    name=f"ckpt-d2h_{i}") for i in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    bg = [s for s in tracer.spans() if s.name == "ckpt.d2h.background"]
    assert len(bg) == 1
    bg = bg[0]
    assert bg.attrs == {"step": 12, "kind": "full"}
    assert bg.parent == save.id and bg.thread.startswith("ckpt-d2h_")
    assert bg.start >= save.start and bg.end >= bg.start
    # a span on another thread has no parent on this one
    out = []

    def other():
        with tracer.span("elsewhere") as s:
            out.append(s)
    with tracer.span("here", step=3):
        th = threading.Thread(target=other)
        th.start()
        th.join(timeout=10)
    assert out[0].parent is None and "step" not in out[0].attrs


def test_the_bounded_buffer_counts_the_spans_it_drops():
    t = Tracer(capacity=4)
    t.enable()
    for i in range(10):
        with t.span("s", step=i):
            pass
    kept = t.spans()
    assert [s.attrs["step"] for s in kept] == [6, 7, 8, 9]   # the newest
    assert t.dropped == 6
    t.reset()
    assert t.spans() == [] and t.dropped == 0
    # a span opened before the reset is not kept after it
    with t.span("old"):
        t.reset()
    assert t.spans() == []


def test_main_thread_spans_are_on_the_profilers_timeline():
    t = Tracer()
    t.enable()
    x = torch.ones(64, 64)

    def work():
        with t.span("ckpt.d2h.worker"):
            (x @ x).sum()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.span("trainer.step", step=1):
            with t.span("train.grad"):
                (x @ x).sum()
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=10)
    t.disable()
    names = {e.name for e in prof.events()}
    assert {"repro_torch.trainer.step", "repro_torch.train.grad"} <= names
    assert "repro_torch.ckpt.d2h.worker" not in names
    assert [s.name for s in t.spans()] == ["train.grad", "trainer.step",
                                           "ckpt.d2h.worker"]
    step = next(e for e in prof.events()
                if e.name == "repro_torch.trainer.step")
    grad = next(e for e in prof.events()
                if e.name == "repro_torch.train.grad")
    assert step.time_range.start <= grad.time_range.start
    assert grad.time_range.end <= step.time_range.end


def _trainer(tmp_path):
    from repro_torch.config import CheckpointPlan, OptimizerConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.stream import EventStream, constant_rate
    from repro_torch.runtime import ResilientTrainer, TrainerConfig

    plan = CheckpointPlan(interval_s=1.0, mode="incremental", full_every=3,
                          encode_placement="device", delta_codec="int8",
                          levels=("memory",), sync=True,
                          replication_factor=0)
    tcfg = TrainerConfig(batch=4, seq_len=16, ckpt_dir=str(tmp_path),
                         time_scale=20.0, detect_s=1.0, restart_s=1.0,
                         plan=plan)
    return ResilientTrainer(get_smoke_config("yi-6b"), tcfg,
                            EventStream(schedule=constant_rate(500.0)),
                            OptimizerConfig(total_steps=1000, lr=1e-3),
                            device="cpu")


def _job(tr):
    """Steps, two fulls and their deltas, a task failure restored from
    memory (a delta's snapshot, so a state away from the base), and a
    delta after it (which takes the landing again)."""
    def saves():
        return [e["kind"] for e in tr.events if e["event"] == "checkpoint"]
    while len(saves()) < 5 or saves()[-1] != "delta":
        tr.run(duration_s=2.0)
    tr.inject_failure_at(tr.t, "task")
    while not any(e["event"] == "restore" for e in tr.events):
        tr.run(duration_s=2.0)
    after = len(tr.events)
    while not any(e["event"] == "checkpoint" and e["kind"] == "delta"
                  for e in tr.events[after:]):
        tr.run(duration_s=2.0)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A traced job's trainer and spans."""
    timing.reset()
    timing.enable()
    try:
        tr = _trainer(tmp_path_factory.mktemp("on"))
        _job(tr)
    finally:
        timing.disable()
    spans = timing.spans()
    timing.reset()
    return tr, spans


def test_the_programs_spans_over_a_job(tmp_path, job):
    """With the tracer off the job records nothing; on, every span of the
    step, the checkpoint plane and the restore appears, each under its
    step or trigger."""
    timing.reset()
    _job(_trainer(tmp_path / "off"))
    assert timing.spans() == []
    tr, spans = job
    names = {s.name for s in spans}
    assert names == {
        "trainer.step", "trainer.h2d", "trainer.loss_read", "data.batch",
        "train.grad", "train.optim", "ckpt.save", "ckpt.full.base",
        "ckpt.delta.pack", "ckpt.delta.encode", "ckpt.delta.stats",
        "ckpt.d2h.first", "ckpt.d2h.queue", "ckpt.d2h.wait",
        "ckpt.landing.pin", "trainer.restore", "ckpt.restore",
        "ckpt.restore.snapshot", "ckpt.restore.copy",
        "trainer.restore.h2d"} | ({"ckpt.d2h.background"} & names)
    by_id = {s.id: s for s in spans}
    steps = [s for s in spans if s.name == "trainer.step"]
    restore = next(s for s in spans if s.name == "ckpt.restore")
    restored = next(e for e in tr.events if e["event"] == "restore")["step"]
    # steps count up by one from the state's step, and from the restored
    # step after the restore
    before = [s.attrs["step"] for s in steps if s.end < restore.start]
    after = [s.attrs["step"] for s in steps if s.start > restore.end]
    assert before == list(range(1, len(before) + 1))
    assert after == list(range(restored + 1, restored + 1 + len(after)))
    assert len(before) + len(after) == len(tr.losses)
    for s in spans:
        up = by_id.get(s.parent)
        if s.name in ("train.grad", "train.optim", "trainer.h2d",
                      "trainer.loss_read"):
            assert up.name == "trainer.step"
            assert s.attrs["step"] == up.attrs["step"]
        if s.name.startswith(("ckpt.delta.", "ckpt.d2h.", "ckpt.full.")):
            while up.name != "ckpt.save":
                up = by_id[up.parent]
            assert (s.attrs["step"], s.attrs["kind"]) == \
                (up.attrs["step"], up.attrs["kind"])
    saves = [s for s in spans if s.name == "ckpt.save"]
    trig = [e for e in tr.events if e["event"] == "checkpoint"]
    assert [(s.attrs["step"], s.attrs["kind"], s.attrs["bytes_on_link"])
            for s in saves] == [(e["step"], e["kind"], e["bytes_on_link"])
                                for e in trig]
    # each trigger's step is that of the train step before it, or the
    # restored step where none has run since the restore
    for save in saves:
        since = save.start < restore.start or None
        prev = [s for s in steps if s.end <= save.start
                and (since or s.start > restore.end)]
        want = prev[-1].attrs["step"] if prev else restored
        assert save.attrs["step"] == want
    pins = [s for s in spans if s.name == "ckpt.landing.pin"]
    assert [p.start > restore.end for p in pins] == [False, True]


#: the parts of each save and of the restore, in the order they run: a
#: save of that kind, or the restore span, is their direct parent
PARTS = {
    "delta": ("ckpt.save", ("ckpt.delta.pack", "ckpt.delta.encode",
                            "ckpt.delta.stats", "ckpt.d2h.first",
                            "ckpt.d2h.queue", "ckpt.d2h.wait")),
    # the base's pack goes first; a CPU tensor's full (this job runs on the
    # CPU) then copies its first chunk, where a CUDA one only queues
    "full": ("ckpt.save", ("ckpt.full.base", "ckpt.d2h.first",
                           "ckpt.d2h.queue")),
    "restore": ("ckpt.restore", ("ckpt.restore.snapshot",
                                 "ckpt.restore.copy")),
}


@pytest.mark.parametrize("what", sorted(PARTS))
def test_each_save_and_the_restore_hold_their_parts(job, what):
    """Each delta save holds its pack, encode, stats, first chunk, queueing
    and wait; each full its base, first chunk and queueing; the restore its
    snapshot's D2H and its copy, under the trainer's restore and before the
    trainer's H2D.  The parts run in order inside their parent and carry
    its step and kind (the landing's pin, once before the first delta and
    once after the restore, is the only other part of a save)."""
    tr, spans = job
    parent_name, parts = PARTS[what]
    parents = [s for s in spans if s.name == parent_name
               and (what == "restore" or s.attrs.get("kind") == what)]
    want = {"delta": 3, "full": 2, "restore": 1}[what]
    assert len(parents) >= want
    for up in parents:
        kids = sorted((s for s in spans if s.parent == up.id),
                      key=lambda s: s.start)
        named = [s for s in kids if s.name != "ckpt.landing.pin"]
        assert tuple(s.name for s in named) == parts
        assert [s.name for s in kids if s not in named] in (
            [], ["ckpt.landing.pin"])
        assert up.start <= kids[0].start and kids[-1].end <= up.end
        for a, b in zip(kids, kids[1:]):
            assert a.end <= b.start
        for s in kids:
            assert {k: s.attrs.get(k) for k in ("step", "kind")} == \
                {k: up.attrs.get(k) for k in ("step", "kind")}
    if what == "restore":
        outer = next(s for s in spans if s.id == parents[0].parent)
        assert outer.name == "trainer.restore"
        assert [s.name for s in sorted(
            (s for s in spans if s.parent == outer.id),
            key=lambda s: s.start)] == ["ckpt.restore", "trainer.restore.h2d"]
    else:
        kinds = [e["kind"] for e in tr.events if e["event"] == "checkpoint"]
        assert len(parents) == kinds.count(what)
