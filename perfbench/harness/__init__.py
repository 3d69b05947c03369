"""The harness: one general traffic generator, the load loop, the
end-to-end metrics, the traced span and the check, shared by every cell."""
