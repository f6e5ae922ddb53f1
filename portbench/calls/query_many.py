"""One call drains ``batches_per_call`` distinct batches through
``NNEngine.query_many``: the j-th call takes the next batches of the pool,
in turn."""


def units(traffic: dict, pool_size: int, j: int) -> list[int]:
    """The pool indices of the j-th call's batches, in queue order."""
    w = traffic["batches_per_call"]
    return [(j * w + b) % pool_size for b in range(w)]


def make_call(engine, traffic: dict, pool: list):
    """``call(j)``: the j-th call, (pool indices, answers in queue order)."""
    def call(j):
        us = units(traffic, len(pool), j)
        return us, engine.query_many([pool[u] for u in us])
    return call
