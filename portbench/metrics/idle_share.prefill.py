"""Per cent of the traced window in which no operation ran on the device, read as
``idle_share.surveil`` reads it: a unit (a prefill) in place of a batch."""

from portbench.harness import reader

read = reader("idle_share.surveil")
