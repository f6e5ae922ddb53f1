"""One call is one ``NNEngine.query`` of one batch, taken from the pool
in turn."""


def units(traffic: dict, pool_size: int, j: int) -> list[int]:
    """The pool index of the j-th call's batch."""
    if traffic["batches_per_call"] != 1:
        raise ValueError("a query call answers one batch")
    return [j % pool_size]


def make_call(engine, traffic: dict, pool: list):
    """``call(j)``: the j-th call, ([pool index], [answers])."""
    def call(j):
        us = units(traffic, len(pool), j)
        return us, [engine.query(pool[us[0]])]
    return call
