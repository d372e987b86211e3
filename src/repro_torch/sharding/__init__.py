"""Distribution layer: logical-axis rules, parameter / cache / batch
specs as DTensor placements, and the GPipe pipeline."""
