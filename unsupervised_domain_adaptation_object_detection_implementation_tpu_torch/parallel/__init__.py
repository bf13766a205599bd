"""Multi-device training (counterpart of the JAX package's `parallel/`):
the (data, model) layout of the ranks (`mesh`), the global-batch forms of
the modules that couple rows (`batch`), the Megatron split of the box
head (`shardings`), process-group set-up and rank launch (`multihost`),
and a dry run of the multi-device programs (`dryrun`)."""

from .mesh import Axis, Layout, make_layout, mesh_from_cfg, use_layout
from .multihost import init_multihost, run_ranks

__all__ = ['Axis', 'Layout', 'make_layout', 'mesh_from_cfg', 'use_layout',
           'init_multihost', 'run_ranks']
