"""``stencil_iterate``'s reference: ``steps`` plain steps, one a pass;
the field is judged by the family's ``field_drift``."""


def expect(state, op):
    state.step(op, 1)
