"""The benchmark's harness: the cell's files found by name
(:mod:`.spec`), what the drivers under ``drivers/`` share
(:mod:`.window`), the traced stretch (:mod:`.trace`), the check against
the plain reference (:mod:`.check`) and one run of a cell (:mod:`.main`)."""
