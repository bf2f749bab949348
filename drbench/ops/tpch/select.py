"""``select``: the rows of ``table`` that meet every predicate of
``where`` (``[column, "<" | "<=" | "==" | ">=" | ">", value]``), with
the columns ``keep`` as the frame's ``<as>.<column>``; the column
``row`` is each kept row's position among them (int32).  Plain torch
masks: the user's own code before the port's calls.  With ``"work":
"rows"`` the table's rows count as the call's work."""

import torch

CMP = {"<": torch.lt, "<=": torch.le, "==": torch.eq, ">=": torch.ge,
       ">": torch.gt}


def run(prog, op):
    t = prog.tables[op["table"]]
    mask = None
    for col, cmp, value in op["where"]:
        m = CMP[cmp](t[col], value)
        mask = m if mask is None else mask.logical_and_(m)
    idx = torch.nonzero(mask).squeeze(1)
    for col in op["keep"]:
        prog.put(f"{op['as']}.{col}", torch.arange(
            idx.numel(), device=idx.device, dtype=torch.int32)
            if col == "row" else t[col][idx])
    n = next(iter(t.values())).numel()
    return {op["work"]: n} if "work" in op else {}
