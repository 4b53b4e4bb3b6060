"""impop_tpu — a population-genomics engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of pangenome/impop
(reference surveyed in SURVEY.md): nucleotide diversity (pi), Hudson's Fst
(direct / grouped / 3-pi variants), Tajima's D, allele-frequency spectra,
allele-class clustering and EHH, computed over genomic windows of pangenome
data.

Where the reference is a sequential per-window shell pipeline
(impg -> pica2.py / h-fst.py / tj_d.py, one process per window), this package
expresses every estimator as masked, batched linear algebra on [W, N, N]
similarity tiles or [W, N, S] allele tiles so the hot paths run as matmuls
on the accelerator (an NVIDIA GPU), and scales over windows/panels with
jax.sharding meshes.

Public layers
-------------
- impop_tpu.io       : readers/writers for the reference's on-disk contracts
                       (similarity TSV, panel lists, BED windows)
- impop_tpu.stats    : the estimators (pure functions, jit/vmap friendly)
- impop_tpu.ops      : shared device building blocks (masked panel sums)
- impop_tpu.parallel : mesh construction + sharded window scans
- impop_tpu.runtime  : window batching, result journal, resume, compile cache
- impop_tpu.report   : output tables (reference-identical schemas) and plots
- impop_tpu.cli      : command-line drivers mirroring the reference's scripts
"""

__version__ = "0.1.0"
