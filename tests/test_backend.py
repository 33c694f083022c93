"""The one backend decision, the compile cache location, the native
build, and the GPU smoke script's behaviour off the card (its phases are
rehearsed here at a tiny size on the CPU)."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import hgtpu
from hgtpu import backend
from hgtpu.typer.engine import TypingOptions, use_device_fold

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def on_gpu(monkeypatch):
    """Pretend the process runs on an accelerator."""
    monkeypatch.setattr(backend, "on_accelerator", lambda: True)


def test_backend_predicate_false_on_cpu():
    assert jax.default_backend() == "cpu"
    assert backend.on_accelerator() is False


def test_auto_takes_device_path_on_accelerator(on_gpu):
    from hgtpu.pipeline.genotype import _take_device_path

    assert _take_device_path(TypingOptions(), paired=True)
    assert not _take_device_path(TypingOptions(device_typing="off"), True)
    # options the device program does not model stay on the host
    assert not _take_device_path(TypingOptions(family="codis"), True)
    assert not _take_device_path(TypingOptions(assembly=True), True)


def test_auto_stays_on_host_off_accelerator():
    from hgtpu.pipeline.genotype import _take_device_path

    assert not _take_device_path(TypingOptions(), paired=True)
    assert _take_device_path(TypingOptions(device_typing="on"), True)


@pytest.mark.parametrize("accel", [False, True])
def test_fold_choice_follows_backend(monkeypatch, accel):
    monkeypatch.setattr(backend, "on_accelerator", lambda: accel)
    assert use_device_fold(TypingOptions(), 60) is accel
    assert use_device_fold(TypingOptions(), 3600)       # IMGT width
    assert not use_device_fold(TypingOptions(device_counting="off"), 3600)
    assert use_device_fold(TypingOptions(device_counting="on"), 60)


@pytest.fixture(scope="module")
def one_gene_family():
    """The CLI's devel gene as a one-gene catalog, one allele's paired
    reads, and that family's result on the family engine
    (FamilyAligner -> type_gene, the multi-gene route)."""
    from collections import defaultdict

    import chip_smoke
    from hgtpu.align.family import FamilyAligner
    from hgtpu.db import Catalog
    from hgtpu.sim import simulate_reads
    from hgtpu.typer.engine import type_gene

    ref = chip_smoke.build_cli_gene()
    cat = Catalog(family="hla", genes={"A": ref})
    truth = ref.allele_names[7]
    r1, r2, _ = simulate_reads(ref, [truth], simulate_interval=6, seed=42)
    R1 = [(r.name, r.seq) for r in r1]
    R2 = [(r.name, r.seq) for r in r2]
    fa = FamilyAligner(cat)
    by_read = defaultdict(list)
    for reads, mate in ((R1, "L"), (R2, "R")):
        for a in fa.align_batch([n for n, _ in reads],
                                [q for _, q in reads], mate)["A"]:
            if a is not None:
                by_read[a.read_id.split("|")[0]].append(a)
    family = type_gene(ref, sorted(by_read.items(), key=lambda kv: kv[0]),
                       TypingOptions(device_typing="off"))
    return cat, R1, R2, truth, family


def _same_result(got, want, truth):
    assert got.cmpt == want.cmpt and got.exon_cmpt == want.exon_cmpt
    assert (got.num_reads, got.num_pairs) == (want.num_reads,
                                              want.num_pairs)
    assert got.prob[0][0] == want.prob[0][0] == truth


def test_one_gene_family_takes_device_path(on_gpu, one_gene_family):
    """A one-gene family (the CLI's real-reads path) routes through
    pipeline.type_reads, so "auto" on an accelerator runs the device
    program, with the family engine's result."""
    from hgtpu.pipeline.genotype import type_family
    from hgtpu.utils.trace import TRACE

    cat, R1, R2, truth, family = one_gene_family
    TRACE.reset()
    dev = type_family(cat, R1, R2, opts=TypingOptions())["A"]
    assert "device.countB" in TRACE.summary()
    _same_result(dev, family, truth)


def test_one_gene_family_host_route_matches_family_engine(one_gene_family):
    """Off the accelerator the same route (type_reads) runs the host
    engine, and equals the family engine too: one gene keeps every
    aligned read under the NH==1 rule."""
    from hgtpu.pipeline.genotype import type_family
    from hgtpu.utils.trace import TRACE

    cat, R1, R2, truth, family = one_gene_family
    TRACE.reset()
    host = type_family(cat, R1, R2, opts=TypingOptions())["A"]
    assert not any(k.startswith("device.") for k in TRACE.summary())
    _same_result(host, family, truth)


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    hgtpu.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_fixed_dir_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    hgtpu.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == \
        os.path.join(REPO, ".jax_cache")
    assert hgtpu.CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_native_library_built_from_source(tmp_path):
    """With no library present, the loader builds it from the C++
    sources with make."""
    import ctypes

    from hgtpu.native import LIB_NAME, NATIVE_DIR, library_path

    for f in os.listdir(NATIVE_DIR):
        if f == "Makefile" or f.endswith(".cpp"):
            shutil.copy(os.path.join(NATIVE_DIR, f), tmp_path / f)
    assert not (tmp_path / LIB_NAME).exists()
    path = library_path(str(tmp_path))
    assert path == str(tmp_path / LIB_NAME) and os.path.exists(path)
    lib = ctypes.CDLL(path)
    assert lib.hgtpu_build_sa and lib.hgtpu_verify_batch


def test_em_dense_pinned_precision_matches_float64():
    """The device SQUAREM pins its f32 products to HIGHEST (a GPU would
    run them in TF32) and agrees with the float64 host solver."""
    import jax.numpy as jnp

    import chip_smoke
    from hgtpu.typer.em import _em_dense, _single_abundance_np, \
        em_solve_dense

    rng = np.random.default_rng(5)
    A, C = 40, 25
    M = rng.random((C, A)) < 0.15
    M[:, 0] = True
    counts = rng.integers(1, 80, C).astype(np.float64)
    text = _em_dense.lower(jnp.asarray(M), jnp.asarray(counts, jnp.float32),
                           jnp.ones(A, jnp.float32),
                           jnp.asarray(False)).as_text()
    assert text.count("HIGHEST") >= 3
    names = ["X*%02d" % i for i in range(A)]
    cmpt = {}
    for c in range(C):
        key = "-".join(names[a] for a in np.flatnonzero(M[c]))
        cmpt[key] = cmpt.get(key, 0) + float(counts[c])
    want = dict(_single_abundance_np(cmpt, False, {}))
    got = em_solve_dense(M, counts)
    for i, n in enumerate(names):
        assert abs(got[i] - want.get(n, 0.0)) < chip_smoke.SQUAREM_TOL, n


def _dot_lines(text):
    return [l for l in text.splitlines() if "dot_general" in l]


@pytest.mark.parametrize("solver", ["e2e_em_shard", "sharded_em_iterations"])
def test_device_em_products_pinned_highest(solver):
    """Every product of the production EM (e2e em_shard) and of the
    legacy sharded EM is lowered at HIGHEST precision."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    if solver == "sharded_em_iterations":
        from hgtpu.parallel.sharded import _em_iterations

        M = rng.random((12, 30)) < 0.2
        text = jax.jit(_em_iterations).lower(
            jnp.asarray(M), jnp.ones(12, jnp.float32)).as_text()
    else:
        import chip_smoke
        from hgtpu.parallel.production import _shared_sharded_typer
        from hgtpu.parallel.sharded import make_mesh

        ref = chip_smoke.build_cli_gene()
        st = _shared_sharded_typer(ref, TypingOptions(), make_mesh(8), 100)
        cnt = jnp.asarray(rng.integers(0, 3, (16, ref.n_alleles)),
                          jnp.int32)
        text = st._em_steps[(False, False)].lower(
            cnt, jnp.ones(16, jnp.float32), st._ones, st._ones).as_text()
    dots = _dot_lines(text)
    assert len(dots) >= 3
    assert all("HIGHEST" in l for l in dots), dots


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_rehearsal(on_gpu, tmp_path, capsys):
    """The smoke phases at a tiny size on the CPU, with the predicate
    patched so "auto" takes the device path as it does on the card."""
    import chip_smoke
    from synth import make_gene_msa

    from hgtpu.db import build_gene_ref
    from test_production import _truths

    truth = chip_smoke.phase_cli(str(tmp_path), "cpu rehearsal")
    spec = make_gene_msa(seed=3, n_alleles=40)
    ref, _ = build_gene_ref("A", spec["names"], spec["rows"],
                            spec["ref_allele"], min_var_freq=8.0)
    truths = list(_truths(ref))
    host = chip_smoke.phase_parity(ref, truths, "cpu rehearsal",
                                   runs=((4, 0.0), (3, 0.02)), seed=11)
    chip_smoke.phase_em(ref, host, "cpu rehearsal")
    out = capsys.readouterr().out
    assert "ranked #1 on the device path" in out and truth in out
    assert "device == host" in out and "em:" in out


def test_chip_smoke_parity_rejects_a_difference(on_gpu):
    """check_equal fails on a class-count difference, never passes it."""
    import dataclasses

    import chip_smoke
    from hgtpu.typer.engine import GeneTypingResult

    a = GeneTypingResult(gene="A", num_reads=10, num_pairs=5,
                         counts=[], prob=[["X*01", 1.0]],
                         cmpt={"X*01": 5}, exon_cmpt={},
                         primary_exon_cmpt={})
    chip_smoke.check_equal(a, a, ["X*01"], "same")
    b = dataclasses.replace(a, cmpt={"X*01": 4})
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.check_equal(b, a, ["X*01"], "differs")


@pytest.mark.gpu
def test_scale_parity_on_gpu(gpu):
    """Phase 4 of chip_smoke.py on the card: the 3,600-allele panel at
    full depth, error-free and at 2 % error, device path == host."""
    import chip_smoke

    ref = chip_smoke.build_scale_gene()
    truths = [ref.allele_names[i] for i in chip_smoke.SCALE_TRUTHS]
    chip_smoke.phase_parity(ref, truths, gpu,
                            expect_reads=chip_smoke.SCALE_READS)


def _cli_pairs(ref):
    import chip_smoke

    return chip_smoke.simulate(ref, [ref.allele_names[7]], interval=3,
                               seed=42)


def _compile_place_pairs(ref, reads):
    """Compile the production place pass (jit_place_pairs) for one gene
    and batch on a one-device mesh."""
    import jax.numpy as jnp

    from hgtpu.parallel.production import _shared_sharded_typer
    from hgtpu.parallel.sharded import make_mesh

    st = _shared_sharded_typer(ref, TypingOptions(), make_mesh(1), 100)
    c1 = st._pad(st.encode([q for _, q in reads[0]]), True)
    c2 = st._pad(st.encode([q for _, q in reads[1]]), True)
    st._place_pairs_p.lower(*st._tables, jnp.asarray(c1),
                            jnp.asarray(c2)).compile()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["cli_gene", "scale_panel"])
def test_place_pairs_compiles_on_gpu(gpu, shape):
    """The placement GEMM behind its optimization_barrier compiles on
    the card at the CLI gene's shape (24 alleles, 1.8 kb, where the
    fused product aborted XLA's Triton GEMM emitter) and at the scale
    panel's (3,600 alleles, 3.5 kb, 13,022 reads)."""
    import chip_smoke

    if shape == "cli_gene":
        ref = chip_smoke.build_cli_gene()
        reads = _cli_pairs(ref)
    else:
        ref = chip_smoke.build_scale_gene()
        reads = chip_smoke.simulate(
            ref, [ref.allele_names[i] for i in chip_smoke.SCALE_TRUTHS])
    _compile_place_pairs(ref, reads)


_UNFENCED = """
import sys
sys.path[:0] = [%r, %r]
import jax, jax.numpy as jnp
import chip_smoke
import hgtpu.parallel.e2e as e2e
import test_backend


def unfenced(pwm_ext, reads):
    n, m = reads.shape
    P1 = pwm_ext.shape[0] - m + 1
    lhs = jax.nn.one_hot(reads, 5, dtype=jnp.bfloat16).reshape(n, m * 5)
    idx = jnp.arange(P1)[:, None] + jnp.arange(m)[None, :]
    windows = pwm_ext.astype(jnp.bfloat16)[idx].reshape(P1, m * 5)
    return jnp.dot(lhs, windows.T, preferred_element_type=jnp.float32)


e2e.correlate_scores = unfenced
ref = chip_smoke.build_cli_gene()
test_backend._compile_place_pairs(ref, test_backend._cli_pairs(ref))
print("compiled without the barrier")
"""


@pytest.mark.gpu
def test_place_pairs_barrier_still_needed(gpu, tmp_path):
    """Canary for ops.placement.correlate_scores' optimization_barrier:
    without it, compiling the CLI gene's place pass aborts the process
    on the card (jax 0.9.0).  When a JAX/XLA upgrade makes this compile,
    the barrier can go."""
    script = tmp_path / "unfenced.py"
    script.write_text(_UNFENCED % (REPO, os.path.join(REPO, "tests")))
    # a second process on the card: a small share of its memory
    env = dict(os.environ, XLA_PYTHON_CLIENT_PREALLOCATE="false",
               XLA_PYTHON_CLIENT_MEM_FRACTION="0.1")
    r = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0, (
        "the place pass compiled without its optimization_barrier on jax "
        "%s: the barrier in ops/placement.py is no longer needed"
        % jax.__version__)
    assert "Dimensions must match" in r.stderr, r.stderr[-2000:]
