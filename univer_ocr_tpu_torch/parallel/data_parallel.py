"""Training steps over the mesh (univer_ocr_tpu/parallel/data_parallel.py):
data parallelism with the gradients summed over 'data', and tensor
parallelism of the Char model's dense block over 'model'.

  * DP (`make_dp_train_step`): the batch splits over 'data'; each shard
    computes, on its device and from its own copy of the parameters, the
    sum of its per-sample losses plus the regularization divided by the
    number of shards, and its gradients; the gradients and the output
    losses are summed over the shards in shard order (JAX's `psum`, in a
    fixed order so that a run is deterministic), and one Adam update is
    made on the parameters' masters, on the mesh's first device.

  * TP (`make_tp_char_train_step`): the Char model's dense_1 and dense_2
    weights (the only tensors over 100k parameters in the zoo), and their
    Adam moments, are split by columns over 'model' (`_char_param_spec`);
    the line batch splits over 'data'.  Each dense layer computes each
    column block on its model device and gathers the columns; the loss
    is the whole batch's, as JAX's GSPMD step computes it, and autograd
    carries the backward across the devices.

Neither step launches a CUDA kernel: neither kernel has a backward, and
the models' layers run as plain ops under autograd.
"""

import torch

from ..nn.optimizers import tree_map
from .mesh import Replicated, on_device, replicate, shard, to_device

__all__ = ['shard_batch', 'replicate', 'make_dp_train_step',
           'make_tp_char_train_step', 'ColumnShards']


def shard_batch(batch, mesh):
    """A host batch (arrays or tensors with a leading batch dim, or
    lists, tuples and dicts of them) split over 'data'."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return shard(batch, mesh)


def _master(tree, device):
    """The parameters (or optimizer state) the update applies to: a
    `Replicated` value's first copy, or a plain tree, on `device`."""
    if isinstance(tree, Replicated):
        tree = tree.parts[0]
    return to_device(tree, device)


def _leaves(tree, device):
    """A shard's differentiable copy of a parameter tree on `device`."""
    return tree_map(lambda v: v.detach().to(device).requires_grad_(True),
                    tree)


def _flat(tree):
    return [v for layer in tree.values() for v in layer.values()]


def _unflat(values, like):
    it = iter(values)
    return {n: {k: next(it) for k in layer} for n, layer in like.items()}


def add_in_order(tensors, device):
    """The tensors summed in list order on `device` (JAX's `psum`, in a
    fixed order)."""
    total = tensors[0].to(device)
    for t in tensors[1:]:
        total = total + t.to(device)
    return total


def sum_in_order(trees, device):
    """Trees of tensors summed leaf by leaf in list order, on `device`."""
    return tree_map(lambda *leaves: add_in_order(leaves, device), *trees)


def shard_value_and_grad(loss_fn, params, shards, devices, master):
    """Per shard s, on devices[s] and from its own copy of `params`:
    `loss_fn(leaves, *shards[s]) -> (loss, aux)` and the gradients of
    the loss; the gradients of all shards summed in shard order on
    `master`.  Returns ([aux per shard], grads)."""
    auxes, grads = [], []
    for args, dev in zip(shards, devices):
        with on_device(dev):
            leaves = _leaves(params, dev)
            with torch.enable_grad():
                loss, aux = loss_fn(leaves, *args)
            grads.append(_unflat(torch.autograd.grad(loss, _flat(leaves)),
                                 leaves))
        auxes.append(aux)
    return auxes, sum_in_order(grads, master)


def shards_of(args, mesh):
    """Batch args -> one list of per-shard args per 'data' shard."""
    parts = [shard(a, mesh).parts for a in args]
    return [list(p) for p in zip(*parts)]


def make_dp_train_step(model, mesh):
    """Data-parallel train step of one cascade Model.

    step(params, opt_state, lr, X, y) -> (new_params, new_opt_state,
    out_losses, reg_loss): X and y batched on dim 0 (arrays, tensors or
    `shard_batch` values), params and opt_state plain trees or
    `replicate` values; the new ones are plain trees on the mesh's first
    device."""
    opt = model._optimizer()
    assert opt is not None, 'model needs an optimizer for training'
    n_data = mesh.shape['data']

    def local_loss(p, X, y):
        _, (out_losses, reg_loss, _) = model.loss_fn(p, [X], [y])
        # the regularization counts once over the shards
        return (sum(out_losses) + reg_loss / n_data,
                ([l.detach() for l in out_losses], reg_loss))

    def step(params, opt_state, lr, X, y):
        params = _master(params, mesh.primary)
        opt_state = _master(opt_state, mesh.primary)
        auxes, grads = shard_value_and_grad(
            local_loss, params, shards_of((X, y), mesh),
            mesh.data_devices(), mesh.primary)
        out_losses = [add_in_order([aux[0][k] for aux in auxes],
                                   mesh.primary)
                      for k in range(len(auxes[0][0]))]
        with torch.no_grad():
            new_params, new_state = opt.update(params, grads, opt_state, lr)
        reg_loss = torch.as_tensor(auxes[0][1]).detach()
        return new_params, new_state, out_losses, reg_loss

    return step


def _char_param_spec(layer_name, param_name):
    """The TP rule for Char parameters: the two wide dense weights split
    by columns over 'model'; everything else replicated (None)."""
    if param_name == 'w' and (layer_name.endswith('dense_block/dense_1')
                              or layer_name.endswith('dense_block/dense_2')):
        return 'model'
    return None


class ColumnShards:
    """A matrix split by columns over 'model': `blocks[m]` on the m-th
    model device (JAX's P(None, 'model'))."""

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def full(self, device):
        """The whole matrix on `device`."""
        return torch.cat([b.to(device) for b in self.blocks], dim=1)


def _tensors(tree):
    """The tensors of a {layer: {param: tensor or [block, ...]}} tree, in
    order."""
    for layer in tree.values():
        for v in layer.values():
            yield from (v if isinstance(v, list) else [v])


def _refill(tree, values):
    """`tree`'s structure with its tensors taken from `values`."""
    return {ln: {pn: ([next(values) for _ in v] if isinstance(v, list)
                      else next(values))
                 for pn, v in lp.items()} for ln, lp in tree.items()}


def make_tp_char_train_step(model, mesh):
    """DP x TP train step of the Char model: the line batch splits over
    'data', dense_1 and dense_2 (with their optimizer state) over
    'model'.  Returns (step, place_params, place_opt_state): place the
    host-side trees once, then step(params, opt_state, lr, X, y) ->
    (params, opt_state, out_losses, reg_loss), the trees placed as
    given: `ColumnShards` for the split weights, tensors on the mesh's
    first device for the rest."""
    opt = model._optimizer()
    assert opt is not None
    n_model = mesh.shape['model']
    primary = mesh.primary

    def place(v, spec):
        v = torch.as_tensor(v)
        if spec is None:
            return v.to(primary)
        return ColumnShards(
            block.to(dev).contiguous() for block, dev in zip(
                torch.chunk(v, n_model, dim=1), mesh.model_devices()))

    def place_params(params):
        return {ln: {pn: place(v, _char_param_spec(ln, pn))
                     for pn, v in lp.items()} for ln, lp in params.items()}

    def place_opt_state(params, opt_state):
        return {ln: {pn: {k: place(v, _char_param_spec(ln, pn))
                          for k, v in slots.items()}
                     for pn, slots in lp.items()}
                for ln, lp in opt_state.items()}

    def row_copy(params, row):
        """A data row's differentiable copy of the parameters: the split
        weights as [block on each model device], the rest on the row's
        first device."""
        return {ln: {pn: ([b.detach().to(dev).requires_grad_(True)
                           for b, dev in zip(v.blocks, row)]
                          if isinstance(v, ColumnShards)
                          else v.detach().to(row[0]).requires_grad_(True))
                     for pn, v in lp.items()} for ln, lp in params.items()}

    def apply_on(row):
        """Layers of a data row: a split dense layer computes each column
        block on its model device and gathers the columns."""
        def apply(name, layer, p, inputs):
            if not isinstance(p.get('w'), list):
                return layer.apply(p, inputs)
            cols = []
            for block, dev in zip(p['w'], row):
                with on_device(dev):
                    cols.append(layer.apply({'w': block},
                                            [inputs[0].to(dev)])[0])
            return [torch.cat([c.to(row[0]) for c in cols], dim=1)]
        return apply

    def sum_rows(grads, master):
        """The data rows' gradients of one parameter summed in data
        order, each block on its master's device."""
        if isinstance(master, ColumnShards):
            return [add_in_order([g[m] for g in grads], b.device)
                    for m, b in enumerate(master.blocks)]
        return add_in_order(grads, master.device)

    def update(params, grads, state, lr):
        lr = torch.tensor(lr, dtype=torch.float32)
        new_params, new_state = {}, {}
        for ln, lp in params.items():
            new_params[ln], new_state[ln] = {}, {}
            for pn, v in lp.items():
                g, slots = grads[ln][pn], state[ln][pn]
                if not isinstance(v, ColumnShards):
                    new_params[ln][pn], new_state[ln][pn] = opt.leaf_update(
                        v, g, slots, lr)
                    continue
                outs = [opt.leaf_update(b, g[m], {k: s.blocks[m]
                                                  for k, s in slots.items()},
                                        lr)
                        for m, b in enumerate(v.blocks)]
                new_params[ln][pn] = ColumnShards(o[0] for o in outs)
                new_state[ln][pn] = {k: ColumnShards(o[1][k] for o in outs)
                                     for k in slots}
        return new_params, new_state

    def step(params, opt_state, lr, X, y):
        rows = mesh.devices
        copies = [row_copy(params, row) for row in rows]
        with torch.enable_grad():
            preds = []
            for copy, row, x in zip(copies, rows, shard(X, mesh).parts):
                with on_device(row[0]):
                    preds.append(model.forward_fn(copy, [x],
                                                  apply_layer=apply_on(row)))
            preds = [torch.cat([p[k].to(primary) for p in preds])
                     for k in range(model.outputs_count)]
            y = torch.as_tensor(y).to(primary)
            # the whole batch's loss, as JAX's GSPMD step computes it
            out_losses = [model._loss_for_output(k)(preds[k], y)
                          for k in range(model.outputs_count)]
            whole = {ln: {pn: (torch.cat([b.to(primary) for b in v], dim=1)
                               if isinstance(v, list) else v)
                          for pn, v in lp.items()}
                     for ln, lp in copies[0].items()}
            reg_loss = model.regularization_fn(whole)
            total = sum(out_losses) + reg_loss
        grads = iter(torch.autograd.grad(
            total, [t for copy in copies for t in _tensors(copy)]))
        row_grads = [_refill(copy, grads) for copy in copies]
        grads = {ln: {pn: sum_rows([g[ln][pn] for g in row_grads], v)
                      for pn, v in lp.items()} for ln, lp in params.items()}
        with torch.no_grad():
            new_params, new_state = update(params, grads, opt_state, lr)
        return (new_params, new_state, [l.detach() for l in out_losses],
                torch.as_tensor(reg_loss).detach())

    return step, place_params, place_opt_state
