"""sync_torch_ops (ops, domain layer): the torch operations one warm
Domain.sync dispatches (rank 0), counted by a TorchDispatchMode; the
hand-written kernels' launches are not among them."""


def read(rec):
    t = rec.get("trace")
    return t["sync_torch_ops"] if t else None
