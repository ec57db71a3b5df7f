"""``slate_tpu_torch.gesv_mixed_gmres``: a bfloat16 LU factor and float32
FGMRES refinement, one right-hand side; A and B wrapped as users wrap
them (``Matrix(a, mb=nb)``), ``Option.BlockSize`` nb. The X of each call
is judged; ``iters`` (negative when the full-precision fallback ran) is
recorded for ``refine_iters``."""

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
    F, X, iters = st.gesv_mixed_gmres(A, B, opts)
    return {"x": X.data[:X.m, :X.n], "info": F.info, "iters": int(iters)}
