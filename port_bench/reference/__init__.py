"""The plain reference of the benchmark: a frozen copy, in plain PyTorch
and float32, of the networks, the connected components, the zoom-window
projection, the pose losses and the clipped Adam update that the measured
package runs. It imports nothing of that package. `nets.set_quant` makes
every convolution and dense layer round its operands to a lower precision,
which turns the reference into the precision control of `correct`."""
