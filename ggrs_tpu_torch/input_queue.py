"""Per-player circular input queue with repeat-last-input prediction: the
reference's `input_queue.py`, copied without its telemetry counters.

A 128-slot ring, frame-delay handling including replication when the delay
grows mid-session, repeat-last-input prediction and misprediction detection
on late-arriving real input. The queue is host-side control state.
"""

from __future__ import annotations

from typing import List, Tuple

from .errors import ContractViolation
from .frame_info import PlayerInput
from .types import NULL_FRAME, Frame, InputStatus

INPUT_QUEUE_LENGTH = 128


class InputQueue:
    def __init__(self, input_size: int):
        self.input_size = input_size
        # queue-local prediction tallies: the session's per-player accuracy
        self.predictions_served = 0
        self.mispredictions = 0
        self.head = 0
        self.tail = 0
        self.length = 0
        self.first_frame = True
        self.last_added_frame: Frame = NULL_FRAME
        self.first_incorrect_frame: Frame = NULL_FRAME
        self.last_requested_frame: Frame = NULL_FRAME
        self.frame_delay = 0
        self.inputs: List[PlayerInput] = [
            PlayerInput.blank(NULL_FRAME, input_size) for _ in range(INPUT_QUEUE_LENGTH)
        ]
        # `prediction.frame != NULL_FRAME` means we are in prediction mode.
        self.prediction = PlayerInput.blank(NULL_FRAME, input_size)

    def set_frame_delay(self, delay: int) -> None:
        self.frame_delay = delay

    def reset_prediction(self) -> None:
        self.prediction = PlayerInput(NULL_FRAME, self.prediction.buf)
        self.first_incorrect_frame = NULL_FRAME
        self.last_requested_frame = NULL_FRAME

    def confirmed_input(self, requested_frame: Frame) -> PlayerInput:
        """The confirmed input for a frame; raises if unconfirmed."""
        offset = requested_frame % INPUT_QUEUE_LENGTH
        if self.inputs[offset].frame == requested_frame:
            return self.inputs[offset]
        raise ContractViolation(f"no confirmed input for requested frame {requested_frame}")

    def discard_confirmed_frames(self, frame: Frame) -> None:
        """Drop inputs up to `frame`."""
        if self.last_requested_frame != NULL_FRAME:
            frame = min(frame, self.last_requested_frame)

        if frame >= self.last_added_frame:
            # delete all but most recent
            self.tail = self.head
            self.length = 1
        elif frame <= self.inputs[self.tail].frame:
            pass  # nothing to delete
        else:
            offset = frame - self.inputs[self.tail].frame
            self.tail = (self.tail + offset) % INPUT_QUEUE_LENGTH
            self.length -= offset

    def input(self, requested_frame: Frame) -> Tuple[bytes, InputStatus]:
        """Input for `requested_frame`, or a repeat-last prediction."""
        assert self.first_incorrect_frame == NULL_FRAME, (
            "must not fetch inputs while a misprediction is pending"
        )
        self.last_requested_frame = requested_frame
        assert requested_frame >= self.inputs[self.tail].frame

        if self.prediction.frame < 0:
            # If the frame is in range, return it confirmed.
            offset = requested_frame - self.inputs[self.tail].frame
            if offset < self.length:
                offset = (offset + self.tail) % INPUT_QUEUE_LENGTH
                assert self.inputs[offset].frame == requested_frame
                return self.inputs[offset].buf, InputStatus.CONFIRMED

            # Otherwise enter prediction mode: repeat the last added input.
            if requested_frame == 0 or self.last_added_frame == NULL_FRAME:
                self.prediction = PlayerInput.blank(self.prediction.frame, self.input_size)
            else:
                prev = (self.head - 1) % INPUT_QUEUE_LENGTH
                self.prediction = self.inputs[prev]
            self.prediction = PlayerInput(self.prediction.frame + 1, self.prediction.buf)

        assert self.prediction.frame != NULL_FRAME
        self.predictions_served += 1
        return self.prediction.buf, InputStatus.PREDICTED

    def add_input(self, inp: PlayerInput) -> Frame:
        """Add the next sequential input; returns the frame it landed on after
        frame delay, or NULL_FRAME if dropped."""
        assert (
            self.last_added_frame == NULL_FRAME
            or inp.frame + self.frame_delay == self.last_added_frame + 1
        ), "inputs must be added sequentially"

        new_frame = self._advance_queue_head(inp.frame)
        if new_frame != NULL_FRAME:
            self._add_input_by_frame(inp, new_frame)
        return new_frame

    def _add_input_by_frame(self, inp: PlayerInput, frame_number: Frame) -> None:
        prev = (self.head - 1) % INPUT_QUEUE_LENGTH
        assert self.last_added_frame == NULL_FRAME or frame_number == self.last_added_frame + 1
        assert frame_number == 0 or self.inputs[prev].frame == frame_number - 1

        self.inputs[self.head] = PlayerInput(frame_number, inp.buf)
        self.head = (self.head + 1) % INPUT_QUEUE_LENGTH
        self.length += 1
        assert self.length <= INPUT_QUEUE_LENGTH
        self.first_frame = False
        self.last_added_frame = frame_number

        if self.prediction.frame != NULL_FRAME:
            assert frame_number == self.prediction.frame
            # Record the first misprediction so the session can roll back.
            if self.first_incorrect_frame == NULL_FRAME and not self.prediction.equal(
                PlayerInput(frame_number, inp.buf), True
            ):
                self.first_incorrect_frame = frame_number
                self.mispredictions += 1

            # Exit prediction mode once real input caught up with requests
            # without any misprediction; otherwise keep predicting forward.
            if (
                self.prediction.frame == self.last_requested_frame
                and self.first_incorrect_frame == NULL_FRAME
            ):
                self.prediction = PlayerInput(NULL_FRAME, self.prediction.buf)
            else:
                self.prediction = PlayerInput(self.prediction.frame + 1, self.prediction.buf)

    def _advance_queue_head(self, input_frame: Frame) -> Frame:
        """Apply frame delay; replicate or drop when the delay changed."""
        prev = (self.head - 1) % INPUT_QUEUE_LENGTH
        expected_frame = 0 if self.first_frame else self.inputs[prev].frame + 1
        input_frame += self.frame_delay

        # Delay shrank: no room in the queue for this input; drop it.
        if expected_frame > input_frame:
            return NULL_FRAME

        # Delay grew: replicate the last input to fill the gap.
        while expected_frame < input_frame:
            self._add_input_by_frame(self.inputs[prev], expected_frame)
            expected_frame += 1
            prev = (self.head - 1) % INPUT_QUEUE_LENGTH

        prev = (self.head - 1) % INPUT_QUEUE_LENGTH
        assert input_frame == 0 or input_frame == self.inputs[prev].frame + 1
        return input_frame
