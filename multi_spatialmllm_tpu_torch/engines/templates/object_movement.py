"""Object-movement (TAPVid-3D) template banks (original text).

Parity: single_object_movement_engine_coord.py:108-278 — 30 task
descriptions, 30 questions per type with the coordinate-convention sentence
appended (:209-211), 30 answers per type. Placeholders: {x1} {y1}
{total_distance} {x_value} {y_value} {z_value}.
"""

from . import expand
from .depth import COORD_NOTE

TASK_DESCRIPTION = [
    "Image-1: <image>\nImage-2: <image>\n" + body
    + " Use the first image as the reference; the objects and the camera "
      "each may or may not have moved."
    for body in expand(
        ["Analyze the motion of the scene content and of the camera "
         "between these two frames.",
         "Work out how objects and the capturing camera changed position "
         "across the two images.",
         "Compare the two captures and reason about object and camera "
         "movement.",
         "Study the pair of frames and characterize any object or camera "
         "motion.",
         "Determine what moved — scene content, camera, or both — between "
         "the shots.",
         "Assess the positional changes of objects and viewpoint across "
         "the images."],
        ["", "Movement of either is possible but not guaranteed.",
         "Neither, one, or both may have shifted.",
         "Consider translations in full 3D.",
         "Quantify the changes where asked."],
        limit=30,
    )
]

_Q_DIST_CORE = expand(
    ["How far, in millimeters, did the point at [ {x1} , {y1} ] in "
     "Image-1 travel between the frames?",
     "What total distance (mm) did the point located at [ {x1} , {y1} ] "
     "in Image-1 cover?",
     "State the length of the 3D path of the point at [ {x1} , {y1} ] "
     "in Image-1, in mm.",
     "What is the magnitude of the displacement of the Image-1 point "
     "[ {x1} , {y1} ], in millimeters?",
     "Measure the total movement of the point at [ {x1} , {y1} ] in "
     "Image-1 (mm).",
     "How many millimeters separate the start and end positions of the "
     "point at [ {x1} , {y1} ] in Image-1?"],
    ["", "Give a single number.", "Consider true 3D motion, not pixels.",
     "Report the straight-line 3D distance.",
     "Answer with the metric distance."],
    limit=30,
)

_Q_VEC_CORE = expand(
    ["With the first image's axes (X right, Y down, Z forward), what is "
     "the displacement vector `[ x , y , z ]` in mm of the point at "
     "[ {x1} , {y1} ] in Image-1?",
     "Using X=right, Y=down, Z=forward of Image-1, report the 3D motion "
     "of the point at [ {x1} , {y1} ] as `[ x , y , z ]` in millimeters.",
     "Adopting the first frame's basis (X right, Y down, Z forward), "
     "give the translation vector in mm of the Image-1 point "
     "[ {x1} , {y1} ].",
     "In the coordinate system of Image-1 (X right, Y down, Z forward), "
     "how did the point at [ {x1} , {y1} ] move, as `[ x , y , z ]` mm?",
     "Taking X to the right, Y downward, Z forward in Image-1, what "
     "`[ x , y , z ]` vector in mm describes the motion of the point at "
     "[ {x1} , {y1} ]?",
     "Express, in the first camera's axes (X right, Y down, Z forward), "
     "the mm displacement `[ x , y , z ]` of the point at "
     "[ {x1} , {y1} ] in Image-1."],
    ["", "Components may be negative.", "Round each component to an integer.",
     "Measure from the first frame to the second.",
     "Provide all three components."],
    limit=30,
)

QUESTION_TEMPLATES = {
    "tapvid3d_total_distance": [q + " " + COORD_NOTE for q in _Q_DIST_CORE],
    "tapvid3d_displacement_vector": [q + " " + COORD_NOTE for q in _Q_VEC_CORE],
}

ANSWER_TEMPLATES = {
    "tapvid3d_total_distance": expand(
        ["The point traveled", "Its total displacement is",
         "The point covered", "The 3D path length is",
         "The movement amounts to", "The start and end positions are"],
        ["`{total_distance}` mm.", "`{total_distance}` millimeters.",
         "a distance of `{total_distance}` mm.",
         "`{total_distance}` mm in total.",
         "`{total_distance}` mm apart."],
        limit=30,
    ),
    "tapvid3d_displacement_vector": expand(
        ["The displacement vector is", "The point moved by",
         "Its 3D translation is", "The motion decomposes into",
         "The per-axis movement is", "The point's shift equals"],
        ["`[ {x_value} , {y_value} , {z_value} ]` mm.",
         "`[ {x_value} , {y_value} , {z_value} ]` in millimeters.",
         "the vector `[ {x_value} , {y_value} , {z_value} ]` mm.",
         "`[ {x_value} , {y_value} , {z_value} ]`, in mm.",
         "components `[ {x_value} , {y_value} , {z_value} ]` mm."],
        limit=30,
    ),
}
