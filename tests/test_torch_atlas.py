"""The port's synchronization-overhead atlas and engine crossover against
the reference's, on the CPU.

* ``sweep(smoke=True)``: every row (counters, shapes, makespans), every
  fitted class and every growth factor equal to the reference's, and no
  fit failure in either package.
* ``crossover(smoke=True, device="cpu")``: the reference's row keys,
  sizes, task counts and paths, every row verified and none skipped;
  the seconds are not compared.  Without ``device="cpu"`` it runs on CUDA,
  so on a host without CUDA it raises, as ``DeviceExecutor`` does, rather
  than recording a skipped row.
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.edt import atlas as ref_atlas  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.edt import atlas  # noqa: E402


@pytest.fixture(scope="module")
def sweeps():
    return ref_atlas.sweep(smoke=True), atlas.sweep(smoke=True)


@pytest.mark.parametrize("part", ["rows", "fits", "growth", "fit_failures",
                                  "counters", "classes", "grains",
                                  "workers"])
def test_sweep_matches_reference(sweeps, part):
    want, got = sweeps
    assert got[part] == want[part]


def test_sweep_has_no_fit_failure_and_round_trips(sweeps):
    want, got = sweeps
    assert got["fit_failures"] == [] and want["fit_failures"] == []
    assert json.loads(json.dumps(got)) == got
    assert {r["model"] for r in got["rows"]} == set(edt.MODELS)


def test_sweep_emits_the_reference_lines():
    want, got = [], []
    ref_atlas.sweep(smoke=True, grains=(0.2,), emit=want.append)
    atlas.sweep(smoke=True, grains=(0.2,), emit=got.append)
    assert got == want and len(got) > 1


def test_tables_match_reference():
    assert atlas.EXPECTED == ref_atlas.EXPECTED
    assert atlas.WORKLOADS == tuple(
        atlas.AtlasWorkload(**vars(w)) for w in ref_atlas.WORKLOADS)
    assert (atlas.ATLAS_COUNTERS, atlas.CLASSES, atlas.GRAINS) == (
        ref_atlas.ATLAS_COUNTERS, ref_atlas.CLASSES, ref_atlas.GRAINS)
    assert (atlas.CROSSOVER_SIZES, atlas.CROSSOVER_SMOKE,
            atlas.CROSSOVER_TILES) == (ref_atlas.CROSSOVER_SIZES,
                                       ref_atlas.CROSSOVER_SMOKE,
                                       ref_atlas.CROSSOVER_TILES)


def test_crossover_smoke_matches_reference_shape():
    want = ref_atlas.crossover(smoke=True)
    lines = []
    got = atlas.crossover(smoke=True, device="cpu", emit=lines.append)
    assert [sorted(r) for r in got["rows"]] == [sorted(r) for r in
                                                want["rows"]]
    key = [(r["program"], r["size"], r["n_tasks"], r["path"])
           for r in got["rows"]]
    assert key == [(r["program"], r["size"], r["n_tasks"], r["path"])
                   for r in want["rows"]]
    assert all(r["verified"] and "skipped" not in r for r in got["rows"])
    assert sorted(got["points"]) == sorted(want["points"])
    assert lines[0] == "program,size,n_tasks,path,seconds,per_task_us,verified"
    assert len(lines) == 1 + len(got["rows"]) + len(got["points"])


def test_crossover_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the crossover would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        atlas.crossover(smoke=True)


def test_fit_class_and_indistinct_match_reference():
    insts = atlas.build_instances(atlas.WORKLOADS[2])
    rinsts = ref_atlas.build_instances(ref_atlas.WORKLOADS[2])
    refs = atlas.reference_curves(insts)
    assert refs == ref_atlas.reference_curves(rinsts)
    for cls in atlas.CLASSES:
        ys = [3 * v for v in refs[cls]]
        assert atlas.fit_class(ys, refs) == ref_atlas.fit_class(ys, refs)
        for other in atlas.CLASSES:
            assert atlas._indistinct(refs, cls, other) == \
                ref_atlas._indistinct(refs, cls, other)
