"""Static analysis of the port: the kernel contract checker
(``contracts``), the semiring-law verifier with its cross-check of the
CUDA semiring table (``laws``) and the AST lint pass (``lint``), each
runnable as ``python -m repro_torch.analysis.<pass>``. The runtime
counterpart, the sanitizer, lives in ``repro_torch.core.debug``.

Import note: the kernel wrappers import ``analysis.registry`` to register
their contracts, so this package imports nothing else at package level;
the checker imports the kernels inside ``contracts.check_all``.
"""
from . import registry  # noqa: F401
