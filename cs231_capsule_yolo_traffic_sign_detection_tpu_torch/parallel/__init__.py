"""Scale-out over torch.distributed (counterpart of the JAX parallel/
package): the ('data', 'model') mesh of ranks and its launch
(`mesh`), and the collectives the steps use (`collectives`)."""

from .mesh import (  # noqa: F401
    Mesh,
    gather_replicated,
    initialize_distributed,
    is_primary,
    launch,
    make_mesh,
    maybe_make_mesh,
    mesh_shape,
    parse_mesh_spec,
    place_batch,
    process_batch_slice,
    process_row_slices,
    routing_param_spec,
)
