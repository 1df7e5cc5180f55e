from .krylov import cg, refined_solve  # noqa: F401
