"""The port's content-addressed upload pool (``ops/transfer_cache.py``) and
the engine's ownership rule on it, on the CPU.

Uploads are keyed by content: equal bytes hit, changed bytes miss, the
least recently used entries leave past the byte cap, and the counters say
so.  An engine's refresh never writes into a resident that another engine
may share: the first change replaces the resident with the engine's own
copy, which later refreshes write in place; either way the refreshed
tensor equals a fresh upload of the new content.
"""

import numpy as np
import torch

import scheduler_tpu_torch.actions  # noqa: F401  registry side effects
import scheduler_tpu_torch.plugins  # noqa: F401
from chip_smoke import FLAGSHIP_CONF, engine_for
from scheduler_tpu_torch.ops import transfer_cache
from scheduler_tpu_torch.ops.transfer_cache import TransferCache


def test_hit_and_miss_by_content():
    pool = TransferCache()
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    first = pool.to_device(a)
    assert pool.to_device(a.copy()) is first  # equal bytes: the resident
    assert pool.to_device(a, np.float64) is not first  # another dtype: a miss
    b = a.copy()
    b[1, 2] = -1.0
    second = pool.to_device(b)
    assert second is not first and torch.equal(second, torch.from_numpy(b))
    assert pool.to_device(a.reshape(4, 3)) is not first  # another shape
    # On the CPU a resident is a copy, never a view of the caller's array.
    a[0, 0] = 99.0
    assert float(first[0, 0]) == 0.0
    assert pool.stats()["hits"] == 1 and pool.stats()["misses"] == 4


def test_lru_byte_cap():
    pool = TransferCache(cap_bytes=3 * 400)
    arrays = [np.full(100, i, dtype=np.float32) for i in range(4)]  # 400 bytes each
    residents = [pool.to_device(a) for a in arrays[:3]]
    assert pool.stats()["resident_bytes"] == 1200 and pool.stats()["entries"] == 3
    assert pool.to_device(arrays[0]) is residents[0]  # touch: 0 is now the newest
    pool.to_device(arrays[3])  # over the cap: the least recent, 1, leaves
    assert pool.stats()["entries"] == 3 and pool.stats()["resident_bytes"] == 1200
    assert pool.to_device(arrays[0]) is residents[0]
    assert pool.to_device(arrays[2]) is residents[2]
    assert pool.to_device(arrays[1]) is not residents[1]  # evicted: uploaded anew
    off = TransferCache(cap_bytes=0)
    assert off.to_device(arrays[0]) is not off.to_device(arrays[0])
    assert off.stats()["entries"] == 0


def test_counters():
    pool = TransferCache()
    a = np.ones((4, 8), dtype=np.int32)
    pool.to_device(a)
    pool.to_device(a)
    pool.to_device(a)
    assert pool.reset_counters() == {"hits": 2, "misses": 1, "hit_bytes": 256,
                                     "miss_bytes": 128}
    assert pool.reset_counters() == {"hits": 0, "misses": 0, "hit_bytes": 0, "miss_bytes": 0}
    assert pool.stats()["entries"] == 1
    pool.clear()
    assert pool.stats()["entries"] == 0 and pool.stats()["resident_bytes"] == 0


def _session(cache):
    ssn, eng = engine_for(cache, FLAGSHIP_CONF, "cpu")
    return ssn, eng


def test_refresh_never_writes_a_shared_resident():
    """Two engines on equal node state share the idle resident.  Changing
    one node's idle in the first engine's next session leaves the resident
    (and the second engine) untouched; the first engine now owns its copy,
    a further change writes it in place, and each refreshed tensor equals a
    fresh upload of the new host content."""
    from scheduler_tpu_torch.framework import close_session
    from scheduler_tpu_torch.harness import make_synthetic_cluster

    transfer_cache.clear()
    build = lambda: make_synthetic_cluster(8, 60, tasks_per_job=6).cache  # noqa: E731
    cache1, cache2 = build(), build()
    ssn1, eng1 = _session(cache1)
    _, eng2 = _session(cache2)
    shared = eng1._dyn_dev["idle"]
    assert eng2._dyn_dev["idle"] is shared and not eng1._dyn_owned["idle"]
    before = shared.clone()
    close_session(ssn1)

    def refresh(cache, node_name, cpu_used):
        ssn, _ = _session(cache)  # a fresh session (its own engine is dropped)
        led = ssn.nodes.ledger
        row = led.row_of[node_name]
        led.idle[row, 0] -= cpu_used
        led.used[row, 0] += cpu_used
        eng1._refresh_epoch = -1  # no dirty-set epoch: the whole-tensor compare
        assert eng1._refresh_dynamic(ssn)
        close_session(ssn)

    refresh(cache1, "hn-000003", 500.0)
    assert torch.equal(shared, before) and eng2._dyn_dev["idle"] is shared
    assert eng1._dyn_owned["idle"] and eng1._dyn_dev["idle"] is not shared
    fresh = torch.from_numpy(eng1._host_dyn["idle"].copy())
    assert torch.equal(eng1._dyn_dev["idle"], fresh)
    assert float(eng1._dyn_dev["idle"][3, 0]) == float(before[3, 0]) - 500.0
    owned = eng1._dyn_dev["idle"]
    # The next session's snapshot has node 3 as the cache holds it again and
    # node 5 changed: two rows of eight, written in place.
    refresh(cache1, "hn-000005", 250.0)
    assert eng1._dyn_dev["idle"] is owned
    assert torch.equal(owned, torch.from_numpy(eng1._host_dyn["idle"].copy()))
    assert float(owned[3, 0]) == float(before[3, 0])
    assert float(owned[5, 0]) == float(before[5, 0]) - 250.0
    assert torch.equal(shared, before)
    # K2's node ledger follows the refreshed twin.
    ns0 = eng1._mega_args[0]
    assert torch.equal(ns0[0, :8], owned[:8, 0])
