// K11's on-chip instance (fast_loop_onchip.cuh) compiled for 20 columns a
// lane: n from 513 to 640
#include "fast_loop_onchip.cuh"

JRLQP_FAST_LOOP_ONCHIP_DEFINE(20)
