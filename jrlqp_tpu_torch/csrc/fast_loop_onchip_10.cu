// K11's on-chip instance (fast_loop_onchip.cuh) compiled for 10 columns a
// lane: n from 256 to 320
#include "fast_loop_onchip.cuh"

JRLQP_FAST_LOOP_ONCHIP_DEFINE(10)
