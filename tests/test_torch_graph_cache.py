"""The port's CUDA-graph cache (``mmidv1_tpu_torch.utils.graphs``), driven
on the host: CUDA's graph calls stand in as fakes that record what they
are asked, so that the cache's policy (eager calls before the capture,
least-recently-used eviction, the counters a capture takes back and each
replay adds again) runs without a card. Its three users on the card (the
objective's value call, the AM step, the PT step and sweep) are in
``test_torch_value_graph.py``, ``test_torch_step_graph.py`` and
``test_torch_pt_campaign.py``.
"""

import contextlib
import gc

import pytest
import torch

from mmidv1_tpu_torch.utils import trace
from mmidv1_tpu_torch.utils.graphs import GraphCache


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA's graph calls replaced by fakes; yields the record of the pools
    and devices the captures asked for, and whether the garbage collector
    was on in each."""
    seen = {"pools": [], "devices": [], "collecting": []}

    @contextlib.contextmanager
    def graph(g, pool=None):
        assert isinstance(g, FakeGraph)
        seen["pools"].append(pool)
        seen["collecting"].append(gc.isenabled())
        yield

    @contextlib.contextmanager
    def device(d):
        seen["devices"].append(d)
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "device", device)
    trace.reset()
    yield seen
    trace.reset()


def _build(key, built):
    """Two callables in turn, each counting launches, the second also
    another counter; the second takes the first's output."""
    built.append(key)

    def first():
        trace.count("launches", ("a", key))
        return 10 * key

    def second(x):
        trace.count("launches", ("b", key), 2)
        trace.count("other")
        return x + 1

    return f"held {key}", (first, second)


# (eager calls, capacity, the kind of key 1's call after 1 and 2 were
# captured, the keys held after 3's capture, the kind of key 2's last call,
# the keys held at the end)
POLICIES = [(1, None, "replay", [2, 1, 3], "replay", [1, 3, 2]),
            (2, 2, "replay", [1, 3], "capture", [3, 2]),
            (0, 1, "capture", [3], "capture", [2])]


@pytest.mark.parametrize("eager,capacity,third,after3,last,final", POLICIES)
def test_cache_policy(fake_cuda, eager, capacity, third, after3, last, final):
    """A key's first ``eager`` calls run eagerly and build nothing; the
    next captures the built callables in turn, each into the cache's one
    pool on the key's device, the second given the first's output, with
    the garbage collector off while each is captured and on after; a
    replay refreshes its key, and past ``capacity`` the least recently used
    key is dropped and recaptures when it comes back, with no eager call.
    A capture takes back every counter its callables counted and keeps it
    with its graph, whose replay adds exactly that again. A call without a
    key is always eager."""
    cache = GraphCache("t.graph", eager, capacity)
    built = []

    def call(key):
        before = trace.counts("t.graph")
        entry = cache.get(key, f"dev{key}", 7,
                          lambda: _build(key, built))
        kind, = [k for k, n in trace.counts("t.graph").items()
                 if n != before.get(k, 0)]
        return entry, kind

    for key in (1, 2):
        for _ in range(eager):
            assert call(key) == (None, ("eager", 7))
    assert built == []
    entries = {}
    for key in (1, 2):
        entries[key], kind = call(key)
        assert kind == ("capture", 7) and built[-1] == key
        assert entries[key].held == f"held {key}"
        assert entries[key].outputs == [10 * key, 10 * key + 1]
        assert entries[key].counts == [
            [("launches", ("a", key), 1)],
            [("launches", ("b", key), 2), ("other", (), 1)]]
    for name in ("launches", "other"):        # taken back: each at 0
        assert set(trace.counts(name).values()) == {0}
    assert fake_cuda["pools"] == ["pool"] * 4 and cache.pool == "pool"
    assert fake_cuda["devices"] == ["dev1", "dev2"]
    assert fake_cuda["collecting"] == [False] * 4 and gc.isenabled()

    entry, kind = call(1)
    assert kind == (third, 7)
    entry.replay(0)
    entry.replay(1)
    assert [g.replays for g in entry.graphs] == [1, 1]
    assert trace.counts("launches") == {("a", 1): 1, ("b", 1): 2,
                                        ("a", 2): 0, ("b", 2): 0}
    assert trace.counts("other") == {(): 1}

    for _ in range(eager):
        assert call(3) == (None, ("eager", 7))
    assert call(3)[1] == ("capture", 7)
    assert list(cache.entries) == after3
    n_built = len(built)
    entry, kind = call(2)
    assert kind == (last, 7)
    assert built[n_built:] == ([2] if last == "capture" else [])
    assert entry.outputs == [20, 21]
    assert list(cache.entries) == final

    for _ in range(3):
        assert cache.get(None, "cpu", 5, lambda: pytest.fail("built")) is None
    assert None not in cache.eager
    assert trace.counts("t.graph")[("eager", 5)] == 3
