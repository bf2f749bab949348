"""``select``'s reference: the same predicates as boolean masks."""

import torch

CMP = {"<": torch.lt, "<=": torch.le, "==": torch.eq, ">=": torch.ge,
       ">": torch.gt}


def expect(state, op):
    t = state.tables[op["table"]]
    keep = torch.ones(next(iter(t.values())).numel(), dtype=torch.bool,
                      device=next(iter(t.values())).device)
    for col, cmp, value in op["where"]:
        keep &= CMP[cmp](t[col], value)
    for col in op["keep"]:
        state.frame[f"{op['as']}.{col}"] = (
            torch.arange(int(keep.sum()), device=keep.device,
                         dtype=torch.int32) if col == "row" else t[col][keep])
