"""``slate_tpu_torch.gesv``: the partial-pivot LU solve, A and B wrapped
as the library's users wrap them (``Matrix(a, mb=nb)``, so B's tiles
are nb x nb), ``Option.BlockSize`` nb. The X of each call is judged."""

#: layer -> (module, function): wrapped in a profiler range
#: ``portbench::<layer>`` in traced runs
SPANS = {"panel": ("slate_tpu_torch.linalg.lu", "_lu_panel")}


def prepare(config, traffic, inputs, device):
    import slate_tpu_torch as st
    a, b = inputs["a"], inputs["b"]
    nb = config["block_size"]
    return (st.Matrix(a, mb=nb, device=device),
            st.Matrix(b, mb=nb, device=device),
            {st.Option.BlockSize: nb})


def call(handle):
    import slate_tpu_torch as st
    A, B, opts = handle
    F, X = st.gesv(A, B, opts)
    return {"x": X.data[:X.m, :X.n], "info": F.info}
