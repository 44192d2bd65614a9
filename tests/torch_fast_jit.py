"""``fast_jit``: jax.jit with XLA's costly CPU passes off, for the port's
parity tests, which run the JAX package's functions once or a few times
at smoke size and hold the port against them at f32 tolerances.  The
values are XLA's; the compiles are ~35% shorter."""
import jax

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, **jit_kw):
    """``fn`` jitted and compiled with FAST_COMPILE at each call's argument
    shapes (one compile per wrapper and shape; keyword arguments, if any,
    are static)."""
    cache = {}
    jitted = jax.jit(fn, **jit_kw)

    def call(*args):
        leaves = jax.tree_util.tree_leaves(args)
        key = (jax.tree_util.tree_structure(args),
               tuple((getattr(a, "shape", None), str(getattr(a, "dtype", ""))) for a in leaves))
        if key not in cache:
            cache[key] = jitted.lower(*args).compile(compiler_options=FAST_COMPILE)
        return cache[key](*args)

    return call
