"""Data-parallel inference (univer_ocr_tpu/parallel/serving.py): a stage's
launch batch split over the mesh's 'data' axis, its parameters
replicated.

The cascade's device stages are batch-parallel, so serving scales by
splitting each launch batch over the 'data' devices: every shard runs
the stage on its slice, on its own device, and the outputs are merged
in shard order on the mesh's first device.  No shard reads another's
data, so no collective is needed; what every sample may read (the
parameters, the page and crop stacks the gathers index) is copied to
each shard's device.  `OCRPipeline(mesh=...)` routes its stages through
these wrappers.
"""

from .mesh import Replicated, Sharded, gather, on_device, replicate, shard

replicate_params = replicate


def _per_shard(arg, mesh, replicated):
    """One argument's value on each 'data' shard: a `Replicated` value
    gives its parts, a `Sharded` one its slices; a tensor is copied whole
    to each device (`replicated`) or split along dim 0; anything else
    (None, shapes) goes to every shard as it is."""
    n = mesh.shape['data']
    if isinstance(arg, (Replicated, Sharded)):
        return arg.parts
    if not hasattr(arg, 'shape'):
        return [arg] * n
    return (replicate(arg, mesh) if replicated else shard(arg, mesh)).parts


def _run_shards(fn, mesh, per_arg):
    """fn over the shards, each under its device, merged on the mesh's
    first device."""
    outs = []
    for s, dev in enumerate(mesh.data_devices()):
        with on_device(dev):
            outs.append(fn(*(values[s] for values in per_arg)))
    return gather(outs, mesh.primary)


def shard_fn_over_batch(fn, mesh, n_batch_args=1):
    """`fn(params, *batch_args)` with the batch args split over 'data'
    and `params` replicated (a `replicate_params` value, or one that
    `replicate` copies)."""
    def wrapped(params, *batch_args):
        if len(batch_args) != n_batch_args:
            raise TypeError(f'{n_batch_args} batch arguments expected, got '
                            f'{len(batch_args)}')
        return _run_shards(fn, mesh, [_per_shard(params, mesh, True)] + [
            _per_shard(a, mesh, False) for a in batch_args])

    return wrapped


def shard_cascade_stage(fn, mesh, n_replicated, static_argnums=()):
    """A cascade stage for sharded serving: the first `n_replicated` args
    (the parameters, the page or crop stack every sample may read) go
    whole to every shard, each copied to the shard's device once per call
    unless already `Replicated`; every later arg but the static ones is
    split over 'data'.  The outputs merge in shard order."""
    static_argnums = frozenset(static_argnums)

    def wrapped(*args):
        return _run_shards(fn, mesh, [
            _per_shard(a, mesh, i < n_replicated or i in static_argnums)
            for i, a in enumerate(args)])

    return wrapped
