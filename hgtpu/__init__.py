"""hgtpu — a genotyping framework for accelerators.

A from-scratch re-design of the capabilities of HISAT-genotype
(reference: DaehwanKimLab/hisat-genotype v1.3.2) built on JAX/XLA/Pallas:

- ``hgtpu.db``       — graph-reference compiler (MSF -> backbone consensus,
                       variant tables, allele<->variant link matrix, haplotype
                       windows) and packed device artifacts.
                       [ref: hisatgenotype_typing_process.py:313-1255]
- ``hgtpu.align``    — device batch aligner (seed lookup + variant-aware
                       extension) replacing the HISAT2 C++ graph FM aligner.
                       [ref: hisat2 CLI invoked at typing_common.py:995-1036]
- ``hgtpu.typer``    — read->allele compatibility counting and the
                       SQUAREM-accelerated EM abundance solver.
                       [ref: typing_core.py:249-2171, typing_common.py:1282]
- ``hgtpu.assemble`` — guided de Bruijn assembly + Viterbi phasing.
                       [ref: hisatgenotype_assembly_graph.py]
- ``hgtpu.sim``      — read simulator with truth-encoded read names.
                       [ref: typing_common.py:696-982]
- ``hgtpu.parallel`` — jax.sharding mesh utilities; multi-chip typing step.
- ``hgtpu.pipeline`` — end-to-end genotyping orchestration.
- ``hgtpu.cli``      — reference-compatible command line front end.
"""

import os

__version__ = "0.1.0"

# the persistent compile cache's home when JAX_COMPILATION_CACHE_DIR is
# unset: fixed, inside the checkout (listed in .gitignore)
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def enable_compilation_cache():
    """Persist XLA compiles across processes (called by the device
    typing paths and the bench).

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself, so when it is set
    (or the cache directory is already configured) nothing changes here.
    Otherwise the cache goes to one fixed directory inside the checkout,
    ``<repo>/.jax_cache``, so every process of the checkout finds the
    programs the others compiled."""
    import jax

    if (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or jax.config.jax_compilation_cache_dir):
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

