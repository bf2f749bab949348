"""``take``'s reference: a gather."""


def expect(state, op):
    idx = state.frame[op["index"]].long()
    for col in op["keep"]:
        state.frame[f"{op['as']}.{col}"] = state.frame[
            f"{op['table']}.{col}"][idx]
