"""The port's four CLI tools against the JAX package's. The mapper
(dream-yara-tpu-torch-mapper against dream-yara-tpu-mapper) on
tests/test_cli.py's toy database: the same arguments give byte-identical
output files, on the default path and with --mesh, SE and PE, sharded and
as BAM. The device comes from DY_PLATFORM; without a card the default
(cuda) is refused. The host tools (indexer, build-filter, update-filter)
write the same files as the reference's from the same FASTA bins. A
subprocess with JAX and the JAX package made unimportable builds a database
with the port's three host tools and maps SE and PE through the port's CLI,
default path and flat path: every file equals the JAX tools' own."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import zipfile

from dream_yara_tpu.cli import build_filter, indexer, update_filter
from dream_yara_tpu.cli import mapper_cli as jcli
from dream_yara_tpu.io.fasta import write_fasta
from dream_yara_tpu.utils.alphabet import decode, revcomp
from dream_yara_tpu_torch.cli import build_filter as t_build_filter
from dream_yara_tpu_torch.cli import indexer as t_indexer
from dream_yara_tpu_torch.cli import mapper_cli as tcli
from dream_yara_tpu_torch.cli import update_filter as t_update_filter
from dream_yara_tpu_torch.io.fasta import write_fasta as t_write_fasta
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


def _tree(d: Path) -> dict:
    """Every file under d by relative path: its bytes, or for an .npz
    archive the bytes of each member (np.savez stamps each member with the
    time of writing, so archives written a second apart differ only in
    those stamps)."""
    out = {}
    for p in sorted(d.rglob("*")):
        if p.is_file():
            if p.suffix == ".npz":
                with zipfile.ZipFile(p) as z:
                    out[p.relative_to(d)] = {n: z.read(n) for n in z.namelist()}
            else:
                out[p.relative_to(d)] = p.read_bytes()
    return out


def _bins(rng, n_bins=4, length=4000):
    return [random_text(rng, length) for _ in range(n_bins)]


JAX_TOOLS = {"indexer": indexer.main, "build-filter": build_filter.main,
             "update-filter": update_filter.main}
PORT_TOOLS = {"indexer": t_indexer.main, "build-filter": t_build_filter.main,
              "update-filter": t_update_filter.main}
FA = ["--bins-dir", "fa", "-o", "db"]
BLOCKED = ["build-filter", *FA, "-bs", "4m", "-k", "19"]
KDX = ["build-filter", *FA, "-ft", "kmer_direct", "-k", "10"]


@pytest.mark.parametrize("steps", [
    [["indexer", *FA]],
    [["indexer", *FA, "--bidir", "--sample-rate", "4"],
     ["indexer", "new.fa", "-o", "db", "--bin-id", "2"]],
    [BLOCKED],
    [KDX],
    [["build-filter", *FA, "-bs", "4m", "-k", "19", "-w", "23",
      "--calib-trials", "8", "--calib-emax", "3"]],
    [BLOCKED, ["update-filter", "new.fa", "-b", "1", "-o", "db"]],
    [KDX, ["update-filter", "new.fa", "-b", "3", "-o", "db", "-ft", "kmer_direct"]],
], ids=["indexer", "indexer-bidir-rate4-rebuild", "build-filter-blocked",
        "build-filter-kdx", "build-filter-minimizer", "update-filter-blocked",
        "update-filter-kdx"])
def test_host_tools_write_the_reference_files(tmp_path, monkeypatch, steps):
    """The port's indexer, build-filter and update-filter, run with the same
    arguments in a directory of their own, write the same files as the JAX
    package's tools (FASTA bins written by each package's write_fasta)."""
    rng = np.random.default_rng(len(steps) * 31 + len(steps[0]))
    genomes = _bins(rng)
    fresh = random_text(rng, 3000)
    for name, tools, write in (("jax", JAX_TOOLS, write_fasta),
                               ("torch", PORT_TOOLS, t_write_fasta)):
        d = tmp_path / name
        (d / "fa").mkdir(parents=True)
        monkeypatch.chdir(d)
        for b, g in enumerate(genomes):
            write(Path("fa") / f"bin{b}.fa", [f"g{b}", f"h{b}"], [g[:3000], g[3000:]])
        write(Path("new.fa"), ["fresh"], [fresh])
        for tool, *argv in steps:
            tools[tool](list(argv))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    assert got.keys() == want.keys()
    for p, data in want.items():
        assert got[p] == data, p
    assert any(p.parts[0] == "db" for p in got)


_NO_JAX = """
import os, sys
sys.modules["jax"] = None
sys.modules["dream_yara_tpu"] = None
from pathlib import Path
import numpy as np
from dream_yara_tpu_torch.cli import build_filter, indexer, mapper_cli, update_filter
from dream_yara_tpu_torch.io.fasta import write_fasta
os.chdir(sys.argv[1])
rng = np.random.default_rng(2)
gs = [rng.integers(0, 4, 4000).astype(np.int8) for _ in range(4)]
os.mkdir("fa")
for b, g in enumerate(gs):
    write_fasta(Path("fa") / f"b{b}.fa", [f"g{b}"], [g])
write_fasta("new.fa", ["n3"], [gs[3]])
indexer.main(["--bins-dir", "fa", "-o", "db", "--bidir"])
build_filter.main(["--bins-dir", "fa", "-o", "db", "-bs", "4m", "-k", "19"])
update_filter.main(["new.fa", "-b", "3", "-o", "db"])
acgt = np.frombuffer(b"ACGT", np.uint8)
tc = lambda w: np.where(w < 4, 3 - w, w)[::-1]
with open("se.fq", "wb") as se, open("r1.fq", "wb") as f1, open("r2.fq", "wb") as f2:
    for i in range(12):
        g = gs[i % 4]
        p = int(rng.integers(0, 3600))
        for fh, w in ((se, g[p:p + 100]), (f1, g[p:p + 100]),
                      (f2, tc(g[p + 250:p + 350]))):
            fh.write(b"@r%d\\n%s\\n+\\n%s\\n" % (i, acgt[w].tobytes(), b"I" * 100))
os.environ["DY_PLATFORM"] = "cpu"
for reads in (["se.fq"], ["r1.fq", "r2.fq"]):
    for mode in ([], ["--mesh"]):
        mapper_cli.main(["db", *reads, "-o", f"{len(reads)}{len(mode)}.sam",
                         "-e", "0.03", "-ll", "350", "-ld", "60", *mode])
assert not any(m.split(".")[0] in ("jax", "dream_yara_tpu") for m in sys.modules
               if sys.modules[m] is not None)
print("NO_JAX_CLI_OK")
"""


def test_cli_and_flat_path_without_jax(tmp_path, on_cpu, monkeypatch):
    """With jax and dream_yara_tpu blocked, the port's three host tools
    build a 4-bin database (bidirectional sidecars, a blocked filter with
    one bin updated) and the port's mapper maps SE and PE on the default
    and the flat path; the JAX tools and mapper, run the same way, write
    the same files."""
    port = tmp_path / "torch"
    port.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", _NO_JAX, str(port)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_CLI_OK" in r.stdout
    ref = tmp_path / "jax"
    ref.mkdir()
    monkeypatch.chdir(ref)
    (ref / "fa").mkdir()
    for f in [*sorted((port / "fa").iterdir()), port / "new.fa", port / "se.fq",
              port / "r1.fq", port / "r2.fq"]:
        (ref / f.relative_to(port)).write_bytes(f.read_bytes())
    indexer.main(["--bins-dir", "fa", "-o", "db", "--bidir"])
    build_filter.main(["--bins-dir", "fa", "-o", "db", "-bs", "4m", "-k", "19"])
    update_filter.main(["new.fa", "-b", "3", "-o", "db"])
    for reads in (["se.fq"], ["r1.fq", "r2.fq"]):
        for mode in ([], ["--mesh"]):
            jcli.main(["db", *reads, "-o", f"{len(reads)}{len(mode)}.sam",
                       "-e", "0.03", "-ll", "350", "-ld", "60", *mode])
    want, got = _tree(ref), _tree(port)
    assert got.keys() == want.keys()
    for p, data in want.items():
        assert got[p] == data, p
    sam = (port / "20.sam").read_bytes().split(b"\n")
    recs = [l.split(b"\t") for l in sam if l and not l.startswith(b"@")]
    assert len(recs) == 24 and all(int(f[1]) & 2 for f in recs)   # proper pairs
