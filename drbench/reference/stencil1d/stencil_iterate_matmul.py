"""``stencil_iterate_matmul``'s reference: ``steps`` steps in passes of
``k_block``; the field is judged by the family's ``field_drift``."""


def expect(state, op):
    state.step(op, op["k_block"])
