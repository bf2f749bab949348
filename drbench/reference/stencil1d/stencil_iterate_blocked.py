"""``stencil_iterate_blocked``'s reference: ``steps`` steps in passes of
``time_block``; the field is judged by the family's ``field_drift``."""


def expect(state, op):
    state.step(op, op["time_block"])
