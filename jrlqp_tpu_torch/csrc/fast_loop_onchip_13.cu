// K11's on-chip instance (fast_loop_onchip.cuh) compiled for 13 columns a
// lane: n from 321 to 416: the IK width, 387
#include "fast_loop_onchip.cuh"

JRLQP_FAST_LOOP_ONCHIP_DEFINE(13)
