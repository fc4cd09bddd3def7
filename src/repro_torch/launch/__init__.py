"""repro_torch.launch -- ranks, meshes and sharding rules, the production
round step (``steps``), the dry run (``dryrun``, ``hillclimb``,
``agg_compare``: the ``meta`` device, no card), host env, kernel build
cache and the drivers (``serve``, ``train``).

Submodules are exposed lazily (PEP 562), so that ``repro_torch.launch.env``
can be imported, and ``configure_host()`` called, before the first
``import torch`` in the process, as the reference's package allows before
jax.
"""

_LAZY = {
    "make_local_mesh": ("mesh", "make_local_mesh"),
    "MeshPlan": ("sharding", "MeshPlan"),
    "make_plan": ("sharding", "make_plan"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    mod = importlib.import_module(f".{mod_name}", __name__)
    return getattr(mod, attr)
