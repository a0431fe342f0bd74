"""The port's mapper CLI (dream-yara-tpu-torch-mapper) against the JAX
package's (dream-yara-tpu-mapper) on tests/test_cli.py's toy database: the
same arguments give byte-identical output files, on the default path and
with --mesh, SE and PE, sharded and as BAM. The device comes from
DY_PLATFORM; without a card the default (cuda) is refused. A subprocess
with JAX made unimportable builds a database and maps through the port's
CLI, default path and flat path."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dream_yara_tpu.cli import build_filter, indexer
from dream_yara_tpu.cli import mapper_cli as jcli
from dream_yara_tpu.io.fasta import write_fasta
from dream_yara_tpu.utils.alphabet import decode, revcomp
from dream_yara_tpu_torch.cli import mapper_cli as tcli
from tests.conftest import random_text

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def toy_db(tmp_path_factory):
    """3 bins of 5,000 bp with a bloom filter; 12 SE reads and 4 pairs."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    genomes = [random_text(rng, 5000) for _ in range(3)]
    (tmp / "fa").mkdir()
    for b, g in enumerate(genomes):
        write_fasta(tmp / "fa" / f"bin{b}.fa", [f"g{b}"], [g])
    indexer.main(["--bins-dir", str(tmp / "fa"), "-o", str(tmp / "db")])
    build_filter.main(["--bins-dir", str(tmp / "fa"), "-o", str(tmp / "db"),
                       "-bs", "4m", "-k", "19"])

    def rec(name, codes):
        return b"@%s\n%s\n+\n%s\n" % (name, decode(codes).encode(),
                                      b"I" * len(codes))

    with open(tmp / "se.fq", "wb") as fh:
        for b, g in enumerate(genomes):
            for i in range(4):
                p = int(rng.integers(0, len(g) - 100))
                fh.write(rec(b"b%dr%d" % (b, i), g[p : p + 100]))
    with open(tmp / "r1.fq", "wb") as f1, open(tmp / "r2.fq", "wb") as f2:
        for i in range(4):
            g = genomes[i % 3]
            p = int(rng.integers(0, len(g) - 400))
            f1.write(rec(b"pr%d" % i, g[p : p + 100]))
            f2.write(rec(b"pr%d" % i, revcomp(g[p + 200 : p + 300])))
    return tmp


@pytest.fixture
def on_cpu(monkeypatch, tmp_path_factory):
    monkeypatch.setenv("DY_PLATFORM", "cpu")
    monkeypatch.setenv("DY_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))


@pytest.mark.parametrize("reads,extra,out", [
    (["se.fq"], [], "out.sam"),
    (["r1.fq", "r2.fq"], [], "out.sam"),
    (["se.fq"], ["--mesh"], "out.sam"),
    (["r1.fq", "r2.fq"], ["--mesh", "-sm", "record"], "out.sam"),
    (["se.fq"], ["--output-shards", "shards"], "out.sam"),
    (["r1.fq", "r2.fq"], ["--mesh", "--output-shards", "shards"], "out.bam"),
])
def test_cli_output_equals_jax(toy_db, on_cpu, monkeypatch, tmp_path, reads,
                               extra, out):
    """Both CLIs run in their own directory with the same arguments (the
    @PG CL field records them); their output files are identical."""
    args = [str(toy_db / "db"), *(str(toy_db / r) for r in reads), "-o", out,
            "-e", "0.03", "-ll", "300", "-ld", "50", *extra]
    files = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        main(list(args))
        files[name] = {p.relative_to(d): p.read_bytes()
                       for p in sorted(d.rglob("*")) if p.is_file()}
    assert files["torch"].keys() == files["jax"].keys()
    for p, data in files["jax"].items():
        assert files["torch"][p] == data, p
    body = files["torch"][Path(out)]
    if out.endswith(".sam"):
        recs = [l for l in body.split(b"\n") if l and not l.startswith(b"@")]
        assert len(recs) >= (12 if reads == ["se.fq"] else 8)
        assert all(int(r.split(b"\t")[1]) & 4 == 0 for r in recs)


def test_cli_device_choice_and_refusals(toy_db, monkeypatch, capsys):
    """DY_PLATFORM unset means the card: with none here, the CLI exits
    non-zero and does not fall back to the CPU; an unknown platform and the
    multi-host flags are refused too."""
    args = [str(toy_db / "db"), str(toy_db / "se.fq"), "-o", "-", "-e", "0.03"]
    monkeypatch.delenv("DY_PLATFORM", raising=False)
    assert not torch.cuda.is_available()
    for env, extra, msg in ((None, [], "no CUDA device"),
                            ("tpu", [], "DY_PLATFORM='tpu'"),
                            ("cpu", ["--coordinator", "h:1"], "ROADMAP item 16")):
        if env is not None:
            monkeypatch.setenv("DY_PLATFORM", env)
        with pytest.raises(SystemExit) as e:
            tcli.main(args + extra)
        assert e.value.code not in (0, None)
        assert msg in str(e.value.code) + capsys.readouterr().err


_NO_JAX = """
import os, sys
sys.modules["jax"] = None
from pathlib import Path
import numpy as np
from dream_yara_tpu_torch._shared import (run_build_filter, run_indexer,
                                          write_fasta)
from dream_yara_tpu_torch.cli import mapper_cli
tmp = Path(sys.argv[1])
rng = np.random.default_rng(2)
gs = [rng.integers(0, 4, 4000).astype(np.int8) for _ in range(3)]
(tmp / "fa").mkdir()
for b, g in enumerate(gs):
    write_fasta(tmp / "fa" / f"b{b}.fa", [f"g{b}"], [g])
run_indexer(["--bins-dir", str(tmp / "fa"), "-o", str(tmp / "db"), "--bidir"])
run_build_filter(["--bins-dir", str(tmp / "fa"), "-o", str(tmp / "db"),
                  "-bs", "4m", "-k", "19"])
acgt = np.frombuffer(b"ACGT", np.uint8)
with open(tmp / "r.fq", "wb") as fh:
    for i in range(9):
        p = int(rng.integers(0, 3900))
        fh.write(b"@r%d\\n%s\\n+\\n%s\\n" % (i, acgt[gs[i % 3][p:p + 100]].tobytes(), b"I" * 100))
os.environ["DY_PLATFORM"] = "cpu"
for mode in ([], ["--mesh"]):
    mapper_cli.main([str(tmp / "db"), str(tmp / "r.fq"), "-o",
                     str(tmp / f"out{len(mode)}.sam"), "-e", "0.03", *mode])
body = [[l for l in (tmp / f"out{k}.sam").read_text().splitlines()
         if not l.startswith("@PG")] for k in (0, 1)]
assert body[0] == body[1] and len(body[0]) == 3 + 1 + 9, body[0]
assert all(l.split("\\t")[5] == "100M" for l in body[0][4:])
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
print("NO_JAX_CLI_OK")
"""


def test_cli_and_flat_path_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_CLI_OK" in r.stdout
