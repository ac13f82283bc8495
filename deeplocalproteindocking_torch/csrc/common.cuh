// Shared includes of the hand-written Hopper kernels of the torch port.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
