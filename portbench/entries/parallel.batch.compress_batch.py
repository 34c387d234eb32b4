"""``parallel.batch.compress_batch(images, quality, mesh=..., precision=...,
block_index=True)`` over the mesh ``make_mesh()`` gives (every visible card
of this process: a ``LocalMesh``, one thread a card), built once in
set-up.  ``counters`` hands the traced run each call's ``mesh.last_run``
(each shard's wall, thread CPU and collective seconds)."""

KIND = "encode"


def setup(ctx):
    from tinyimgcodec_tpu_torch.parallel import batch, make_mesh

    cards = ctx.config["cards"]
    if ctx.device is None:
        mesh = make_mesh()
    else:
        mesh = make_mesh(devices=[ctx.device] * cards)
    if mesh.size != cards:
        raise ValueError(f"make_mesh() gave {mesh.size} shards, the "
                         f"configuration wants {cards}")
    return {"batch": batch, "mesh": mesh, "config": ctx.config}


def call(state, images):
    c = state["config"]
    return state["batch"].compress_batch(
        images, c["quality"], mesh=state["mesh"], precision=c["precision"],
        block_index=c["block_index"], index_stride=c["index_stride"])


def counters(state):
    return {"last_run": [dict(r) for r in state["mesh"].last_run]}
