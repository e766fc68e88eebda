"""Operations and bytes counted from shapes, and the chip's peaks."""
