"""Test only: ``slate_tpu_torch.gels`` on a tall m x n A, its X (n x nrhs)
judged by the least-squares check."""

SPANS = {}


def prepare(config, traffic, inputs, device):
    import slate_tpu_torch as st
    nb = config["block_size"]
    return (st.Matrix(inputs["a"], mb=nb, device=device),
            st.Matrix(inputs["b"], mb=nb, device=device),
            {st.Option.BlockSize: nb}, config["n"])


def call(handle):
    import slate_tpu_torch as st
    A, B, opts, n = handle
    X = st.gels(A, B, opts)
    return {"x": X.data[:n, :B.n]}
