"""The frozen counts of work.py give chip_smoke.py's bytes and operations
on the same arguments: every kernel call of a CPU map, captured."""

import importlib.util
import os

import pytest
from conftest import ROOT, tiny_config

from portbench import work
from portbench.genome import make_genome, write_fasta


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("K,e,dimer", [(30, 2, None), (60, 2, True), (20, 1, True)])
def test_frozen_counts_equal_chip_smoke(tmp_path, monkeypatch, K, e, dimer):
    from genmap_tpu_torch.engine.mappability import MappabilityEngine
    from portbench import program

    init = MappabilityEngine.__init__
    monkeypatch.setattr(MappabilityEngine, "__init__",
                        lambda self, *a, **kw: init(self, *a, dimer_tier=dimer, **kw))
    smoke = chip_smoke()
    g = make_genome(tiny_config((3000, 1500)), 7)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, g)
    program.build_index(fa, str(tmp_path / "idx"), 10)
    seen = {}

    def on_call(name, args, result):
        got = work.kernel_work(name, args, result)
        if name == "seed_build":
            want = smoke.seed_build_work(args, tables=result)[:2]
        else:
            want = smoke.kernel_work(name, args)[:2]
        assert got == want, name
        seen[name] = seen.get(name, 0) + 1

    out = tmp_path / "o"
    out.mkdir()
    with program.kernel_calls(on_call, work.COUNTED):
        res = program.map_job(["-I", str(tmp_path / "idx"), "-O", str(out) + "/", "-K",
                               str(K), "-E", str(e), "-fs", "-r"], "cpu")
    assert res["rc"] == 0
    print(sorted(seen))
    assert {"extract_needles", "compact", "count_tail", "seed_build"} <= set(seen)
    if dimer:
        assert "dimer_step" in seen
