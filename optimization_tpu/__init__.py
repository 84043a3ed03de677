"""optimization_tpu — a JAX suite of iterative optimization methods.

A from-scratch JAX / XLA re-design with the capabilities of the
david-m-rosen/Optimization C++ template library: Riemannian truncated-Newton
trust-region (TNT) with a Steihaug-Toint truncated preconditioned projected CG
inner solver, Riemannian gradient descent with Armijo line search,
truncated-Newton nonlinear least squares (TNLS) over LSQR, the LOBPCG block
eigensolver, proximal gradient (ISTA/FISTA), and (accelerated) ADMM — all as
fully-jitted ``lax.while_loop`` programs over PyTree variables, vmappable over
problem batches and shardable over device meshes.
"""

from . import core, io, linalg, manifolds, solvers
from .core import driver
from .core.host import Stopwatch
from .core.problem import (CompositeProblem, LeastSquaresProblem,
                           RiemannianProblem)
from .core.types import (ADMMStatus, GradientDescentStatus,
                         ProximalGradientStatus, TNLSStatus, TNTStatus)
from .solvers.euclidean import (euclidean_gradient_descent, euclidean_tnls,
                                euclidean_tnt)

__version__ = "0.1.0"
