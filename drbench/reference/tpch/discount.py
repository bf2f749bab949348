"""``discount``'s reference: ``price * (1 - discount)`` at the state's
precision."""


def expect(state, op):
    p = state.low(state.frame[op["price"]])
    d = state.low(state.frame[op["discount"]])
    state.frame[op["as"]] = p * (1 - d)
