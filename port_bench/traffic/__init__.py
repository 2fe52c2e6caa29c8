"""Traffic generators: rendered tabletop frames for the serving cells and
staged DenseFusion batches for the training cells. Each cell's mix is a
data file beside them (`<traffic>.json`) that one of these generators
reads."""
