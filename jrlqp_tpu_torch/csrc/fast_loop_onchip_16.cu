// K11's on-chip instance (fast_loop_onchip.cuh) compiled for 16 columns a
// lane: n from 417 to 512
#include "fast_loop_onchip.cuh"

JRLQP_FAST_LOOP_ONCHIP_DEFINE(16)
