"""Visual-correspondence template banks (original text).

Parity targets: visual_correspondence_qa_engine_coor_2_coor.py:19-117 and
visual_correspondence_qa_engine_dot_2_multichoice.py:30-120. Placeholders:
{x1} {y1} {x2} {y2} {correct_label}.
"""

from . import expand
from .depth import COORD_NOTE

COOR_TASK_DESCRIPTION = [
    f"Image-1: <image>\nImage-2: <image>\n{body} {COORD_NOTE}"
    for body in expand(
        ["Match the queried point across the two images.",
         "Find where the indicated point reappears in the other view.",
         "Establish the pixel correspondence between the two photographs.",
         "Track the given point from the first view into the second.",
         "Relate the marked location in one image to the other image.",
         "Solve the point-correspondence problem for these views."],
        ["Both views show the same static scene.",
         "The images depict one unchanged scene from two viewpoints.",
         "Assume nothing in the scene moved between the shots.",
         "Only the camera differs between the two pictures.",
         "The scene is identical; the viewpoints differ."],
        limit=30,
    )
]

COOR_QUESTIONS = expand(
    ["A point sits at [ {x1} , {y1} ] in Image-1.",
     "Consider the location [ {x1} , {y1} ] of the first image.",
     "Take the pixel [ {x1} , {y1} ] in the first view.",
     "The first image contains a query point at [ {x1} , {y1} ].",
     "Suppose we mark [ {x1} , {y1} ] in Image-1.",
     "Image-1 has a point of interest at [ {x1} , {y1} ]."],
    ["Where does it appear in Image-2?",
     "What are its coordinates in the second image?",
     "Give its position in the second view.",
     "Locate the same physical point in Image-2.",
     "To which coordinates does it map in the second image?"],
    limit=30,
)

COOR_ANSWERS = expand(
    ["It maps to", "In Image-2 it appears at", "The matching position is",
     "The same point lies at", "Its coordinates in the second view are",
     "The correspondence lands at"],
    ["`[ {x2} , {y2} ]`.", "`[ {x2} , {y2} ]` in Image-2.",
     "`[ {x2} , {y2} ]` in the second image.",
     "coordinates `[ {x2} , {y2} ]`.",
     "the location `[ {x2} , {y2} ]`."],
    limit=30,
)

DOT_TASK_DESCRIPTION = [
    f"Image-1: <image>\nImage-2: <image>\n{body}"
    for body in expand(
        ["A colored circle marks one point in Image-1; Image-2 carries "
         "four lettered candidate points.",
         "One point is circled in the first image and four labeled "
         "options appear in the second.",
         "The first view has a single circled point; the second view "
         "shows candidates A-D.",
         "Image-1 contains a circled query point and Image-2 contains "
         "four lettered marks.",
         "A dot highlights a point in Image-1, while Image-2 offers four "
         "letter-tagged choices.",
         "The query point is circled in Image-1; pick among the lettered "
         "points of Image-2."],
        ["Both views show the same static scene.",
         "The scene is identical; only the camera moved.",
         "Assume nothing in the scene changed between the shots.",
         "The two photographs capture one unchanged scene.",
         "Only the viewpoint differs between the images."],
        limit=30,
    )
]

DOT_QUESTIONS = expand(
    ["Which lettered point in Image-2 corresponds to the circled point "
     "of Image-1?",
     "Of the candidates A, B, C and D in Image-2, which one matches the "
     "circle in Image-1?",
     "Pick the label in the second image that marks the same physical "
     "point as the circle in the first.",
     "The circle in Image-1 reappears as which lettered mark in Image-2?",
     "Identify the letter in Image-2 at the location of the circled "
     "point from Image-1.",
     "Which of the four labeled points is the true correspondence of "
     "the circled point?"],
    ["", "Answer with the letter.", "Reply with one of A, B, C or D.",
     "Give only the correct label.", "State the matching label."],
    limit=30,
)

DOT_ANSWERS = expand(
    ["The matching point is", "The correspondence is point",
     "The correct choice is", "The circled point maps to",
     "In Image-2 the right mark is", "The answer is point"],
    ["`{correct_label}`.", "`{correct_label}` in Image-2.",
     "the one labeled `{correct_label}`.",
     "label `{correct_label}`.",
     "`{correct_label}`, the labeled candidate."],
    limit=30,
)
